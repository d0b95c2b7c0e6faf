"""Share of the rounds' rows whose distances were recomputed: the rows
the Hamerly bounds could not settle (sum of n_recomputed over sum of b)."""


def read(run):
    b = sum(u.get("sum_b", 0) for u in run.units)
    if not b:
        return None
    return 100.0 * sum(u["sum_recomputed"] for u in run.units) / b
