#!/usr/bin/env python
"""Smoke run of the batched QP/SQP main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # the sharded path over four cards only

Phases (one card), all through the public entry points
(``parallel.batch.sqp_solve_batch`` / ``qp_solve_batch``, ``impl="fused"``):

* ``gpu-tests`` — the test suite's ``gpu``-marked tests, in a child process
  that holds the card before this one opens it;
* ``sqp-n32``  — the headline sphere-cap NLP family, n=32, B=4096, f32;
* ``sqp-n128`` — the same family at n=128, B=1024 (the north-star width);
* ``qp-n32``   — random batched QPs (``models.mpc.random_qp_batch``),
  n=32 m=33, B=4096, f32;
* ``admm-chunk`` — the fused tier's inner ADMM chunk at D=65 B=4096 and
  D=257 B=1024.

Each phase is compared with a plain reference and held to a stated bar
(``BARS``); any miss fails the run.  The card's name and power limit come
from ``nvidia-smi`` in a child that does not import JAX.  The last stdout
line is ``{"ok": true, "device": {...}}``; the script exits non-zero and
prints no such line when JAX finds no GPU or a phase fails.

Compile cache: ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it),
otherwise ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Accuracy bars.  The closed-form and tier-agreement bars are the ones the
# CPU tests hold the fused tier to (tests/test_fused_sqp.py,
# tests/test_fused_qp.py); the certificate is the reference SQP's own
# tolerance (src/sqp.cpp:19-20).
BARS = {
    "sqp_solved_frac": 1.0,       # every lane SOLVED
    "sqp_max_err": 1e-5,          # |x - x*|, f32 on the card vs the closed form
    "sqp_cert_frac": 1.0,         # f64 numpy KKT certificate at 1e-4
    "sqp_vmap_f64_max_diff": 1e-6,  # fused vs vmap tier, both f64, 256 lanes
    "qp_vmap_max_diff": 1e-4,     # fused f32 vs vmap f64, 256 lanes
    "qp_status_flips": 1,         # at most one status flip in those lanes
    "chunk_rel_err": 1e-4,        # f32 chunk vs numpy f64, relative
    "sharded_max_diff": 1e-6,     # four-card sharded vs one-card solve
}
SUBSAMPLE = 256
REPS = 20


def log(*a):
    print(*a, flush=True)


def compile_cache_dir(env=os.environ) -> str:
    return env.get("JAX_COMPILATION_CACHE_DIR") or str(ROOT / ".jax_cache")


def card_name_and_power() -> list:
    """One ``name, power.limit`` line per card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


def timed(fn, *args, reps=REPS):
    """Median, quartiles and extremes (ms) of `reps` completed calls; the
    warm-up (compile) call is outside the window."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    return {"median_ms": med, "q1_ms": q1, "q3_ms": q3,
            "min_ms": min(ts), "max_ms": max(ts), "reps": reps}


class Phases:
    def __init__(self):
        self.failed = []

    def check(self, phase, name, value, bar, ok):
        verdict = "ok" if ok else "MISS"
        log(f"  [{phase}] {name} = {value!r} (bar {bar!r}) {verdict}")
        if not ok:
            self.failed.append(f"{phase}:{name}")


def headline_settings(n):
    """bench.py's headline SQP configuration (n=32) and its n=128 twin."""
    from sqp_solver_tpu.qp import QPSettings
    from sqp_solver_tpu.sqp import SQPSettings

    qp = QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=50,
                    check_termination=10, warm_start=True, adaptive_rho=True,
                    adaptive_rho_interval=50, schedule="fixed")
    if n <= 32:
        return SQPSettings(max_iter=3, eps_prim=2e-3, eps_dual=2e-3,
                           termination="kkt", schedule="fixed", polish=True,
                           polish_passes=2, line_search_max_iter=5, qp=qp)
    return SQPSettings(max_iter=2, eps_prim=2e-3, eps_dual=2e-3,
                       termination="kkt", schedule="fixed", polish=True,
                       polish_passes=3, polish_sweeps=4,
                       line_search_max_iter=5, qp=qp)


def phase_sqp(ph, n, B):
    import jax
    import jax.numpy as jnp

    from sqp_solver_tpu.models.benchmark import (
        sphere_cap_kkt_residuals,
        sphere_cap_nlp_batch,
        sphere_cap_solution,
    )
    from sqp_solver_tpu.parallel.batch import sqp_solve_batch

    name = f"sqp-n{n}"
    log(f"{name}: sphere-cap NLP n={n} B={B} f32, fused tier")
    settings = headline_settings(n)
    problem, x0 = sphere_cap_nlp_batch(B, n, seed=0, dtype=jnp.float32)
    solve = jax.jit(lambda p, x: sqp_solve_batch(p, x, None, settings, impl="fused"))
    t = timed(solve, problem, x0, reps=10)
    res = solve(problem, x0)
    st = np.asarray(res.info.status)
    err = np.abs(np.asarray(res.x, np.float64) - sphere_cap_solution(problem)).max(axis=1)
    pv, dr = sphere_cap_kkt_residuals(problem, res.x, res.lam)
    cert = float(np.mean((pv <= 1e-4) & (dr <= 1e-4)))
    log(f"  [{name}] time {t['median_ms']:.3f} ms median (IQR {t['q1_ms']:.3f}-"
        f"{t['q3_ms']:.3f}) -> {B / t['median_ms'] * 1e3:.0f} solves/s")
    ph.check(name, "solved_frac", float(np.mean(st == 0)), BARS["sqp_solved_frac"],
             np.mean(st == 0) >= BARS["sqp_solved_frac"])
    log(f"  [{name}] err_p99 {np.percentile(err, 99):.3e}")
    ph.check(name, "max_err", float(err.max()), BARS["sqp_max_err"],
             err.max() < BARS["sqp_max_err"])
    log(f"  [{name}] primal_viol max {pv.max():.3e}, stationarity max {dr.max():.3e}")
    ph.check(name, "cert_frac_1e-4", cert, BARS["sqp_cert_frac"],
             cert >= BARS["sqp_cert_frac"])

    # tier agreement in float64 on a subsample: fused vs per-problem vmap
    sub = jax.tree.map(lambda v: jnp.asarray(v[:SUBSAMPLE], jnp.float64), problem)
    x0s = jnp.asarray(x0[:SUBSAMPLE], jnp.float64)
    fused = jax.jit(lambda p, x: sqp_solve_batch(p, x, None, settings, impl="fused"))(sub, x0s)
    ref = jax.jit(lambda p, x: sqp_solve_batch(p, x, None, settings, impl="vmap"))(sub, x0s)
    diff = float(np.abs(np.asarray(fused.x) - np.asarray(ref.x)).max())
    ph.check(name, f"vmap_f64_max_diff[{SUBSAMPLE}]", diff,
             BARS["sqp_vmap_f64_max_diff"], diff <= BARS["sqp_vmap_f64_max_diff"])
    f32_vs_f64 = float(np.abs(np.asarray(res.x[:SUBSAMPLE], np.float64)
                              - np.asarray(ref.x)).max())
    log(f"  [{name}] f32 fused vs f64 vmap max diff {f32_vs_f64:.3e} (reported)")
    return t


def phase_qp(ph):
    import jax
    import jax.numpy as jnp

    from sqp_solver_tpu.models.mpc import random_qp_batch
    from sqp_solver_tpu.parallel.batch import qp_solve_batch
    from sqp_solver_tpu.qp import QPSettings

    name = "qp-n32"
    B = 4096
    log(f"{name}: random QPs n=32 m=33 B={B} f32, fused tier")
    # bench.py's qp-batch configuration.  (At the CPU test's eps 1e-6 a
    # few percent of these n=32 QPs cannot converge in f32 at all — the
    # same on CPU — so an f32-vs-f64 comparison there counts f32's floor,
    # not the tier.)
    s = QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200,
                   check_termination=25, adaptive_rho=True,
                   adaptive_rho_interval=50, schedule="fixed")
    qp = random_qp_batch(batch=B, n=32, m=33, seed=0, dtype=jnp.float32)
    solve = jax.jit(lambda p: qp_solve_batch(p, s, impl="fused"))
    t = timed(solve, qp, reps=10)
    res = solve(qp)
    st = np.asarray(res.info.status)
    log(f"  [{name}] time {t['median_ms']:.3f} ms median (IQR {t['q1_ms']:.3f}-"
        f"{t['q3_ms']:.3f}) -> {B / t['median_ms'] * 1e3:.0f} QPs/s; "
        f"solved {np.mean(st == 0):.4f}")
    sub = jax.tree.map(lambda v: jnp.asarray(v[:SUBSAMPLE], jnp.float64), qp)
    ref = jax.jit(lambda p: qp_solve_batch(p, s, impl="vmap"))(sub)
    diff = float(np.abs(np.asarray(res.x[:SUBSAMPLE], np.float64) - np.asarray(ref.x)).max())
    flips = int(np.sum(st[:SUBSAMPLE] != np.asarray(ref.info.status)))
    ph.check(name, f"vmap_f64_max_diff[{SUBSAMPLE}]", diff, BARS["qp_vmap_max_diff"],
             diff <= BARS["qp_vmap_max_diff"])
    ph.check(name, "status_flips", flips, BARS["qp_status_flips"],
             flips <= BARS["qp_status_flips"])
    return t


def phase_chunk(ph):
    import jax
    import jax.numpy as jnp

    from sqp_solver_tpu.qp.admm_batched import admm_chunk

    sys.path.insert(0, str(ROOT / "tests"))
    from test_fused_qp import chunk_inputs, numpy_chunk

    out = {}
    for B, n, m in ((4096, 32, 33), (1024, 128, 129)):
        name = f"admm-chunk D={n + m} B={B}"
        args = chunk_inputs(B, n, m, seed=1, dtype=jnp.float32)
        chunk = jax.jit(lambda *a: admm_chunk(*a, alpha=1.6, seg=10))
        t = timed(chunk, *args)
        got = chunk(*args)
        ref = numpy_chunk(*(a[:64] for a in args), alpha=1.6, seg=10)
        rel = max(float(np.max(np.abs(np.asarray(g[:64], np.float64) - r) / (1.0 + np.abs(r))))
                  for g, r in zip(got, ref))
        w_mb = B * (n + m) ** 2 * 4 / 1e6
        log(f"  [{name}] seg=10: {t['median_ms']:.4f} ms median (IQR {t['q1_ms']:.4f}-"
            f"{t['q3_ms']:.4f}, {t['reps']} reps); W {w_mb:.1f} MB read per iteration "
            f"-> {10 * w_mb / t['median_ms']:.0f} GB/s")
        ph.check(name, "rel_err_vs_numpy_f64[64]", rel, BARS["chunk_rel_err"],
                 rel <= BARS["chunk_rel_err"])
        out[name] = t
    return out


def phase_gpu_tests(ph):
    """The suite's `gpu`-marked tests, in a child that holds the card
    alone (this process has not opened it yet)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "-rs"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    log(f"gpu-tests: {tail}")
    ok = proc.returncode == 0 and " passed" in tail and "skipped" not in tail
    if not ok:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
    ph.check("gpu-tests", "pytest -m gpu", tail, "all passed, none skipped", ok)


def phase_four_cards(ph, devices):
    import jax
    import jax.numpy as jnp

    from sqp_solver_tpu.models.benchmark import sphere_cap_nlp_batch
    from sqp_solver_tpu.models.mpc import random_qp_batch
    from sqp_solver_tpu.parallel.batch import qp_solve_batch, sqp_solve_batch
    from sqp_solver_tpu.parallel.sharding import (
        make_mesh,
        shard_batch,
        sharded_qp_solve_batch,
        sharded_sqp_solve_batch,
    )
    from sqp_solver_tpu.qp import QPSettings

    mesh = make_mesh(devices)
    B = 4 * 4096
    settings = headline_settings(32)
    problem, x0 = sphere_cap_nlp_batch(B, 32, seed=0, dtype=jnp.float32)
    qp = random_qp_batch(batch=B, n=32, m=33, seed=0, dtype=jnp.float32)
    qs = QPSettings(alpha=1.6, eps_abs=1e-4, eps_rel=1e-4, max_iter=200,
                    check_termination=25, adaptive_rho=True,
                    adaptive_rho_interval=50, schedule="fixed")
    one = devices[0]
    cases = (
        ("sharded-sqp",
         lambda: sharded_sqp_solve_batch(shard_batch(problem, mesh), shard_batch(x0, mesh),
                                         None, settings, mesh, impl="fused"),
         lambda: jax.jit(lambda p, x: sqp_solve_batch(p, x, None, settings, impl="fused"))(
             jax.device_put(problem, one), jax.device_put(x0, one))),
        ("sharded-qp",
         lambda: sharded_qp_solve_batch(shard_batch(qp, mesh), qs, mesh, impl="fused"),
         lambda: jax.jit(lambda p: qp_solve_batch(p, qs, impl="fused"))(
             jax.device_put(qp, one))),
    )
    for name, sharded, single in cases:
        log(f"{name}: {B} problems over a 1-D mesh of {len(devices)} cards vs one card")
        res = jax.block_until_ready(sharded())
        ref = jax.block_until_ready(single())
        n_dev = len(res.x.sharding.device_set)
        ph.check(name, "output_devices", n_dev, len(devices), n_dev == len(devices))
        same_st = bool(np.array_equal(np.asarray(res.info.status), np.asarray(ref.info.status)))
        same_it = bool(np.array_equal(np.asarray(res.info.iter), np.asarray(ref.info.iter)))
        ph.check(name, "statuses_equal", same_st, True, same_st)
        ph.check(name, "iterations_equal", same_it, True, same_it)
        diff = float(np.abs(np.asarray(res.x) - np.asarray(ref.x)).max())
        ph.check(name, "x_max_diff", diff, BARS["sharded_max_diff"],
                 diff <= BARS["sharded_max_diff"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path over four cards and its comparison")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    try:
        import sqp_solver_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the solver package is not beside this script ({e})",
              file=sys.stderr)
        return 2

    ph = Phases()
    if not args.four_cards:
        phase_gpu_tests(ph)
        if ph.failed:
            print(f"chip_smoke: FAILED {ph.failed}", file=sys.stderr)
            return 1

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_enable_x64", True)  # for the f64 references only
    try:
        devices = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: JAX found no usable device ({e})", file=sys.stderr)
        return 1
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}", file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}", file=sys.stderr)
        return 1
    log(f"jax {jax.__version__}: {dev.platform} {dev.device_kind} x{len(devices)}")

    if args.four_cards:
        phase_four_cards(ph, devices[:4])
    else:
        phase_sqp(ph, 32, 4096)
        phase_sqp(ph, 128, 1024)
        phase_qp(ph)
        phase_chunk(ph)

    for line in card_name_and_power():
        log(line)
    if ph.failed:
        print(f"chip_smoke: FAILED {ph.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
