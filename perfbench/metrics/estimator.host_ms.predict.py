"""Median over the instrumented requests of the request's time less its
``ops.assign_top2`` time: the estimator's and the copy's share."""
import statistics


def read(run):
    vals = [1e3 * u["wall_s"] - u["ops_ms"].get("assign_top2", 0.0)
            for u in run.instrumented if u["ops_ms"]]
    return statistics.median(vals) if vals else None
