"""observe_ms.serve: mean milliseconds per ``observe`` call (append or
rebuild; the call returns after the swap), timed by the harness."""


def read(run):
    obs = [o["ms"] for o in run.records.get("observes", []) if o["path"] != "error"]
    return sum(obs) / len(obs) if obs else None
