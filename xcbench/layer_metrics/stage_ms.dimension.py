"""Device ms a step of the pipeline stage ``stage.dimension``, from the
program's stage records of the traced window (``xcbench/stage_device.py``)."""

from xcbench import stage_device


def read(tr):
    return stage_device.ms_per_step(tr, "dimension")
