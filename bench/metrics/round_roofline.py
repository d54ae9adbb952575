"""round_roofline (kernels, ``csvm_round_block``): the least time of the
round kernel's traced launches (``frozen.cost.round_block_work`` of a
``max_iter``-round launch at the card's peaks) over their device time.
It also reads ``round_roofline.<suffix>``, the same share under a name
of its own where it moves another end-to-end metric."""
from frozen import cost
from harness import measure

UNIT = "%"
KERNELS = ("round_stream_kernel", "round_block_kernel")


def read(run):
    rounds = run.cell.config["max_iter"]
    return measure.roofline(
        run, KERNELS,
        lambda m, n, p: cost.round_block_work(m, n, p, 4, rounds, False))
