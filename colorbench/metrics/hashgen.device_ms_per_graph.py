"""The hash graph's generation on the card: the device time of what the
launches inside the ``mc.hashgen`` spans started (linked by correlation
id), over those spans, in the profiled replay of the window's first jobs
(``colorbench/spans.py``).  Against ``hashgen.ms_per_graph`` (host clock)
it tells whether generation waits on launches or on the card."""

from colorbench import spans

SOURCE, UNIT = "device_trace", "ms"
LAYER = "hash graph (ops/hashgen.py)"
MOVES = "colorings_per_s"


def read(run):
    return spans.per(run, lambda s: s.device_ns("mc.hashgen") / 1e6, ["mc.hashgen"],
                     device=True)
