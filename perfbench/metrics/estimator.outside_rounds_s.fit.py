"""Seconds of a unit outside the fit's rounds: the engine's shuffle and
upload, validation, the outcome, and predict(X)."""
import statistics


def read(run):
    vals = [u["wall_s"] - u["rounds_s"] for u in run.units
            if "rounds_s" in u]
    return statistics.fmean(vals) if vals else None
