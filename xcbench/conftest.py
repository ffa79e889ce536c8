"""Registers the cell ``era5.local`` and its configuration
``era5_pv16_local`` with the fixtures of ``xcbench/tests``, which cut each
cell they know by name to a tiny size (``TINY_CONFIGS`` and ``TINY_CELLS``
of ``tests/conftest.py``) and alter the answers of each cell's entry
(``FAULTY`` of ``tests/test_xcbench_runs.py``).  Without it the CPU runs
over every cell would run ``era5.local`` at ERA5's full size."""

# the cell at the tiny configuration's 37 x 72 points
TINY_LOCAL = {"kwargs": {"window": 9, "stride": 4, "min_count": 1},
              "kernels": {"K8": {"window": 9, "stride": 4}},
              "reference_kwargs": {"window": 9, "stride": 4,
                                   "min_count": 1}}


def pytest_collection_modifyitems(session, config, items):
    for plugin in config.pluginmanager.get_plugins():
        sizes = getattr(plugin, "TINY_CONFIGS", None)
        cells = getattr(plugin, "TINY_CELLS", None)
        if isinstance(sizes, dict) and isinstance(cells, dict):
            sizes.setdefault("era5_pv16_local", sizes["era5_pv16"])
            cells.setdefault("era5.local", TINY_LOCAL)
    for module in {getattr(item, "module", None) for item in items}:
        faulty = getattr(module, "FAULTY", None)
        if isinstance(faulty, dict):
            faulty.setdefault("era5.local",
                              ("pipeline", "local_length_pipeline"))
