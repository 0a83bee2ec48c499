"""Calls per step that make the host wait for the card
(``torch.cuda.set_sync_debug_mode("warn")`` over three steps after the
traced window): pageable host-to-device copies in the input prep, the
value checks' reads, a readback. Each wait stops the host from running
ahead of the card, so host and device time add up."""
LAYER = "input prep and value checks"


def read(run):
    return run.syncs_per_step
