"""Host ms of the window's admission prefills (between two
synchronizations), per 1,000 true prompt tokens (padding and a group's
duplicate rows not counted)."""


def read(run):
    pre = run.prefills("window")
    n = sum(sum(p["lens"]) for p in pre)
    if not n:
        return None
    return 1e3 * sum(p["ms"] for p in pre) / n
