"""Registers the cell ``era5.lwa_split`` and its configuration
``era5_pv16_lwa_split`` with the fixtures of ``xcbench/tests``, as
``xcbench/conftest.py`` does ``era5.local``: the tiny sizes of
``TINY_CONFIGS`` and ``TINY_CELLS`` of ``tests/conftest.py`` and the
entry that ``FAULTY`` of ``tests/test_xcbench_runs.py`` alters.  It is
loaded where pytest collects this directory, so run ``xcbench/tests`` as
a whole: a run of a single file of ``xcbench/tests`` would take the cell
at ERA5's full 16 x 721 x 1440."""

# the split at the tiny ERA5 grid's 37 x 72 points and its levels
TINY_SPLIT = {"kwargs": {"N": 21, "part": "split", "lwa_method": "auto"},
              "kernels": {"K2": {"N": 21, "C": 1},
                          "K4": {"strides": [1, 1]}},
              "reference_kwargs": {"N": 21}}


def pytest_collection_modifyitems(session, config, items):
    for plugin in config.pluginmanager.get_plugins():
        sizes = getattr(plugin, "TINY_CONFIGS", None)
        cells = getattr(plugin, "TINY_CELLS", None)
        if isinstance(sizes, dict) and isinstance(cells, dict):
            sizes.setdefault("era5_pv16_lwa_split", sizes["era5_pv16"])
            cells.setdefault("era5.lwa_split", TINY_SPLIT)
    for module in {getattr(item, "module", None) for item in items}:
        faulty = getattr(module, "FAULTY", None)
        if isinstance(faulty, dict):
            faulty.setdefault("era5.lwa_split", ("pipeline", "lwa_pipeline"))
