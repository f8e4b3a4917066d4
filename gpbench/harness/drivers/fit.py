"""Driver ``fit``: hyperparameter fitting, Adam step after Adam step.

The window drives ``ExactGP.fit`` (the program's ``fit_gp``) on the cell's
data: one call, whose first ``compare_steps`` steps are set-up (the first
warms every kernel up) and are the steps held to the reference; the window
opens at the end of the last of them and closes at the end of the first
step that ends ``seconds`` after it opened.  Every step ends in the loss's
host read; the window's ends synchronise the card.

What the reference is held to, from the same object that runs the window:
each of the first steps' loss (``fit``'s callback), the first gradient as
the optimizer got it (Adam's first moment after one step over 1 − β₁) and
the parameters after the last of them (the optimizer's own tensors), read
through step hooks on the optimizer.  For ``gpbench/calibrate.py
--detail`` the hooks keep every one of those steps' gradient and
parameters.

The window's records also keep each step's time and loss, whose fifths
``gpbench/run.py`` prints on standard error: the window's later steps run
from a state far from the start, and the step time has to hold there too.
"""

from __future__ import annotations

import time

import torch
from torch.optim import optimizer as optimizer_hooks

from gpbench.harness import program
from gpbench.harness.cell import Outcome
from gpbench.reference import gp as ref


class WindowClosed(Exception):
    pass


def run(ctx) -> Outcome:
    cfg, mix = ctx.config, ctx.traffic
    dev = ctx.device
    X, y = program.make_rows(cfg["n"], cfg, program.generator(ctx.seed, "data", dev), dev)
    ctx.mark("data")
    # fault "half_batch": the program fits half of the rows
    Xp, yp = (X[: cfg["n"] // 2], y[: cfg["n"] // 2]) if "half_batch" in ctx.faults else (X, y)
    gp = program.exact_gp(cfg, "training", dev)
    warm = mix["compare_steps"]
    names = list(gp.init_params(X).keys())  # fit_gp's optimizer takes them in this order
    got = {"losses": [], "start": None, "grads": [], "param_steps": []}
    before = {}
    moments = []
    steps_done = [0]

    def leaves(opt):
        return dict(zip(names, (p for group in opt.param_groups for p in group["params"])))

    def pre_step(opt, args, kwargs):
        before.update({k: p.detach().clone() for k, p in leaves(opt).items()})
        if got["start"] is None:
            got["start"] = dict(before)

    def undo_step(opt, args, kwargs):  # fault "frozen_state": a step changes nothing
        with torch.no_grad():
            for k, p in leaves(opt).items():
                p.copy_(before[k])

    def post_step(opt, args, kwargs):
        steps_done[0] += 1
        if steps_done[0] > warm:
            return
        # the step's gradient from Adam's first moment: m_k = β₁m_{k−1} + (1 − β₁)g_k
        beta1 = opt.param_groups[0]["betas"][0]
        m = {k: opt.state[p]["exp_avg"].detach().clone() for k, p in leaves(opt).items()}
        m_prev = moments[-1] if moments else {k: torch.zeros_like(v) for k, v in m.items()}
        moments.append(m)
        got["grads"].append({k: (m[k] - beta1 * m_prev[k]) / (1 - beta1) for k in m})
        got["param_steps"].append({k: p.detach().clone() for k, p in leaves(opt).items()})

    register = optimizer_hooks
    faulty = "frozen_state" in ctx.faults
    hooks = [register.register_optimizer_step_pre_hook(pre_step)]
    if faulty:
        hooks.append(register.register_optimizer_step_post_hook(undo_step))
    hooks.append(register.register_optimizer_step_post_hook(post_step))
    clock = {"ends": [], "losses": []}

    def callback(i, loss):
        if i < warm:
            got["losses"].append(loss)
        if i == 0:
            ctx.mark("first step")
        if i == warm - 1:
            for h in hooks[-1:] if faulty else hooks:  # none of them in the window
                h.remove()
            clock["t0"], clock["i0"] = ctx.window_start(), i
        elif i >= warm:
            now = time.perf_counter()
            clock["ends"].append(now)
            clock["losses"].append(loss)
            if now - clock["t0"] >= ctx.seconds:
                clock["t1"], clock["steps"] = ctx.window_stop(), i - clock["i0"]
                raise WindowClosed

    try:
        with ctx.span("fit"):
            gp.fit(Xp, yp, steps=2**62, lr=mix["lr"],
                   generator=program.generator(ctx.seed, "probes", dev), callback=callback)
    except WindowClosed:
        pass
    finally:
        for h in hooks:
            h.remove()
    del gp
    records = {"window_s": clock["t1"] - clock["t0"], "steps": clock["steps"],
               "notes": fifths(clock)}
    reference = _once(lambda: reference_run(ctx, X, y))
    return Outcome(
        records=records, attempted=clock["steps"], failed=0,
        judge=lambda: judge(ctx, got, reference()),
        control=lambda rounding: numbers(reference_run(ctx, X, y, rounding), reference(),
                                         start_point(ctx)),
        detail=lambda rounding: {"program": _plain(got), "reference": _plain(reference()),
                                 "control": _plain(reference_run(ctx, X, y, rounding))})


def start_point(ctx) -> dict:
    """The configuration's initial raw hyperparameters as the program holds
    them (float32), in float64."""
    raw = program.raw_hyperparameters(ctx.config["initial_hyperparameters"])
    return {k: torch.tensor(v, dtype=torch.float32, device=ctx.device).double()
            for k, v in raw.items()}


def reference_run(ctx, X, y, rounding=None) -> dict:
    """The reference's first steps (``rounding``: the control's)."""
    cfg, mix = ctx.config, ctx.traffic
    s = cfg["training"]
    out = ref.train_reference(
        X, y, start_point(ctx), program.generator(ctx.seed, "probes", ctx.device),
        steps=mix["compare_steps"], lr=mix["lr"], num_probes=s["num_probes"],
        max_iters=s["max_cg_iters"], tol=s["cg_tol"], rounding=rounding)
    return {"losses": out["losses"], "grads": out["grads"], "param_steps": out["params"]}


def numbers(candidate: dict, reference: dict, start: dict) -> list:
    """The numbers compared: the worst step's loss gap, and for the first
    gradient and the parameters' change the worst leaf's gap of norms,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(candidate["losses"], reference["losses"])]
    g_ref = {k: _norm(v) for k, v in reference["grads"][0].items()}
    g_med = _median(g_ref.values())
    grad_gap = max(abs(_norm(candidate["grads"][0][k]) - g_ref[k]) / max(g_ref[k], g_med)
                   for k in g_ref)
    # a leaf whose reference gradient is nought to rounding moves under Adam
    # by round-off alone: left out of the change by this rule, not by name
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    after, after_ref = candidate["param_steps"][-1], reference["param_steps"][-1]
    c_ref = {k: _norm(after_ref[k] - start[k]) for k in moved}
    c_med = _median(c_ref.values())
    change_gap = max(abs(_norm(after[k].double() - start[k]) - c_ref[k])
                     / max(c_ref[k], c_med) for k in moved)
    return [("loss_gap", max(gaps)), ("grad_gap", grad_gap), ("change_gap", change_gap)]


def judge(ctx, got, reference) -> list:
    start = start_point(ctx)
    # the program has to start where the configuration says
    start_gap = max(abs(float(got["start"][k].double() - start[k])) for k in start)
    return [("start_gap", start_gap)] + numbers(got, reference, start)


def _once(fn):
    memo = []

    def get():
        if not memo:
            memo.append(fn())
        return memo[0]

    return get


def fifths(clock: dict) -> dict:
    """Mean step time (ms) and last loss of each fifth of the window's steps."""
    ends = [clock["t0"]] + clock["ends"]
    k = len(clock["ends"])
    out = {}
    for j in range(5):
        a, b = j * k // 5, (j + 1) * k // 5
        if b > a:
            out[f"fifth {j + 1}"] = {"step_ms": 1e3 * (ends[b] - ends[a]) / (b - a),
                                     "loss": clock["losses"][b - 1]}
    return out


def _plain(r: dict) -> dict:
    """Losses, and each step's gradient and parameters per leaf, as floats."""
    return {"losses": list(r["losses"]),
            "grads": [{k: float(v) for k, v in g.items()} for g in r["grads"]],
            "params": [{k: float(v) for k, v in p.items()} for p in r["param_steps"]]}


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v.double()))


def _median(values) -> float:
    xs = sorted(values)
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])
