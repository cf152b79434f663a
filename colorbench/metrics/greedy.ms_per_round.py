"""The greedy colourers' run seconds over their rounds, summed over the
window's jobs (``Coloring.duration_ms``, ``Coloring.iterations``)."""

SOURCE, UNIT = "program_span", "ms"
LAYER = "greedy colourers (models/greedy_ff.py, models/vff.py)"
MOVES = "colorings_per_s.ell"


def read(run):
    jobs = [j for j in run.jobs if j.spec["colorer"] in ("greedy_ff", "vff")]
    rounds = sum(j.result["rounds"] for j in jobs)
    return 1e3 * sum(j.result["run_s"] for j in jobs) / rounds if rounds else None
