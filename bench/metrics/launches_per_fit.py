"""launches_per_fit (path / tuning, engines): the CSVM kernels' launches
in the window (``kernels.ops.launches`` of ``csvm_round_block``,
``csvm_block_update`` and ``csvm_local_update``) over the fits answered."""
from harness import measure

UNIT = "launches/fit"


def read(run):
    return measure.launches_per_fit(run)
