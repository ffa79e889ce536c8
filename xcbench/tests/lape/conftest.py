"""Registers the cell ``lape.lwa`` and its configuration
``mitgcm_xz_lape`` with the fixtures of ``xcbench/tests``, as
``xcbench/conftest.py`` does ``era5.local``: the tiny sizes of
``TINY_CONFIGS`` and ``TINY_CELLS`` of ``tests/conftest.py`` and the
entry that ``FAULTY`` of ``tests/test_xcbench_runs.py`` alters.  It is
loaded where pytest collects this directory, so run ``xcbench/tests`` as
a whole: a run of a single file of ``xcbench/tests`` would take the cell
at its full 64 x 100 x 4480."""

# the section at 25 levels of 8 m and 112 columns of 80 m: the ridge, its
# partial cells and rock as at full size; 4 snapshots, two overturned
TINY_SECTION = {"grid": {"z": {"first": -4.0, "step": -8.0, "num": 25},
                         "x": {"first": 40.0, "step": 80.0, "num": 112,
                               "periodic": True},
                         "ridge": {"depth": 200.0, "height": 60.0,
                                   "x0": 5000.0, "width": 1200.0},
                         "hFacMin": 0.1},
                "batch": 4}
TINY_LAPE = {"kwargs": {"N": 21, "increase": False, "lt": False,
                        "lwa_method": "auto"},
             "kernels": {"K2": {"N": 21, "C": 1}, "K3": {}, "K5": {}},
             "reference_kwargs": {"N": 21, "increase": False, "lt": False}}


def pytest_collection_modifyitems(session, config, items):
    for plugin in config.pluginmanager.get_plugins():
        sizes = getattr(plugin, "TINY_CONFIGS", None)
        cells = getattr(plugin, "TINY_CELLS", None)
        if isinstance(sizes, dict) and isinstance(cells, dict):
            sizes.setdefault("mitgcm_xz_lape", TINY_SECTION)
            cells.setdefault("lape.lwa", TINY_LAPE)
    for module in {getattr(item, "module", None) for item in items}:
        faulty = getattr(module, "FAULTY", None)
        if isinstance(faulty, dict):
            faulty.setdefault("lape.lwa", ("pipeline", "lwa_pipeline"))
