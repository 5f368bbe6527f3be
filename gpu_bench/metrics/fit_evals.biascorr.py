"""fit_evals.biascorr: residual evaluations a pair of the LM loops in the program's
``coreg.biascorr.fit`` spans (a Jacobian counts as one), from their ``evaluations`` counter."""

from gpu_bench.spans import PREFIX, log


def read(run):
    records = log(run)
    if records is None:
        return None
    fits = [r for r in records if r.name == PREFIX + "coreg.biascorr.fit"]
    return sum(r.counters.get("evaluations", 0) for r in fits) / len(run.calls) if fits else None
