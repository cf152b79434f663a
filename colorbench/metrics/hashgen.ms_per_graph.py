"""Mean time of the hash graph's generation on the card a job
(``Coloring.extra["gen_seconds"]``, host clock ended by a host read)."""

SOURCE, UNIT, LAYER, MOVES = "program_span", "ms", "hash graph (ops/hashgen.py)", "colorings_per_s"


def read(run):
    xs = [j.result["gen_s"] for j in run.jobs if "gen_s" in j.result]
    return 1e3 * sum(xs) / len(xs) if xs else None
