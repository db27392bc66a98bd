"""risk_frac.sweep: the share, in %, of query positions that the
bucketed hybrid reroutes to K2 because they probe an over-cap bucket:
the engine's ``bucketed_risk_frac``, averaged over the window's calls
(every call carries the same number of words).

layer: candidate stage, bucketed (ops/bucketed.py hybrid)
source: program_counter; moves: search_words_per_s
"""


def read(ctx):
    fr = [c["extra"]["bucketed_risk_frac"] for c in ctx.calls if "bucketed_risk_frac" in c["extra"]]
    return 100.0 * sum(fr) / len(fr) if fr else None
