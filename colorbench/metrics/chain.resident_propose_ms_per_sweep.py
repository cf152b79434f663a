"""The resident chain's proposal over NC on the card: the device time of
what the launches inside the ``mc.sweep.propose`` spans started (linked
by correlation id), over the chain bodies, in the profiled replay of the
window's first jobs (``colorbench/spans.py``)."""

from colorbench import spans

SOURCE, UNIT = "device_trace", "ms"
LAYER = "chain, resident (models/mcmc_resident.py, models/mcmc.py)"
MOVES = "colorings_per_s"


def read(run):
    if run.config["path"] != "resident":
        return None
    return spans.per(run, lambda s: s.device_ns("mc.sweep.propose") / 1e6, ["mc.body"],
                     device=True)
