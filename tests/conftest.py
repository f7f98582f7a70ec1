"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests use CPU with ``--xla_force_host_platform_device_count=8`` as the
multi-device fake backend (the analog of the reference's single-binary
GTest setup, with sharding coverage the reference couldn't have).  f64 is
enabled so conformance tests can hit the 1e-6 agreement bar against the
Eigen reference goldens.

Tests marked ``gpu`` check what the card itself computes (its f32
contractions, the chunk as XLA compiles it for the GPU); they skip here
and run on the GPU with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` (``chip_smoke.py``
does this first).
"""

import os
import sys

# The full suite compiles/deserializes ~hundreds of XLA CPU executables in
# one process; each load adds JIT-code mappings, and the process crosses
# the default vm.max_map_count (65530) right at the suite's tail — XLA then
# SEGFAULTS on the failed mmap inside executable (de)serialization
# (measured: ~50k maps at minute 6, ~100 maps/s growth; crash always in
# compilation_cache get/put on the final test).  Raise the sysctl when
# possible (container runs as root); harmless no-op otherwise.
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        if int(_f.read()) < 262144:
            with open("/proc/sys/vm/max_map_count", "w") as _g:
                _g.write("1048576")
except (OSError, PermissionError, ValueError):
    pass

# CPU unless the caller names a platform (the `gpu`-marked tests run
# with JAX_PLATFORMS=cuda)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite is compile-bound on CPU, and the
# traced programs are identical across runs.  $JAX_COMPILATION_CACHE_DIR
# wins when set (JAX reads it itself); otherwise the checkout's own.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".jax_cache", "tests"),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


# ---------------------------------------------------------------------------
# Tiering: the full suite is ~22 min on the 1-core reference host (XLA CPU
# compiles dominate).  Tests measured >= ~7 s there are marked `slow` at
# collection (list from `pytest --durations=0`, re-measured round 5), giving
# a fast tier for the edit loop:   python -m pytest tests/ -m "not slow" -q
# Everything still runs in the full suite (the default).
# ---------------------------------------------------------------------------
import pytest  # noqa: E402

_SLOW_TESTS = {
    "test_diff.py::TestSQPDiff::test_sqp_grads_match_finite_differences",
    "test_diff.py::test_qp_grads_match_finite_differences",
    "test_diff.py::test_inactive_bounds_zero_gradient",
    "test_diff.py::TestSQPDiff::test_x0_gradient_is_zero",
    "test_examples.py",  # every example subprocess
    "test_structured.py::TestArrow",
    "test_structured.py::TestBlockTridiagonal",
    "test_structured.py::TestStructuredFusedTier",
    "test_fused_sqp.py::TestSOCFactorReuse",
    "test_fused_sqp.py::TestFusedSQP::test_polish_rescues_stress_family",
    "test_utils.py::TestBatchedIterationCallback",
    "test_scaling.py::TestClassificationInvariance",
    "test_scaling.py::TestF32Rescue",
    "test_scaling.py::TestSQPInnerScaling",
    "test_scaling.py::TestEquilibration",
    "test_sharding.py",  # 8-device mesh solves
    "test_polish.py::test_sqp_polish_parity_per_problem_vs_batched",
    "test_polish.py::test_polish_improves_accuracy",
    "test_edge_cases.py::TestMixedBounds::test_all_paths_agree",
    "test_edge_cases.py::TestLargeN",
    "test_infeasibility.py::TestCertificates::test_feasible_families_never_flagged",
    "test_infeasibility.py::TestSQPSubproblemCertificates",
    "test_fused_qp.py::TestFusedMatchesVmap::test_batch_padding",
    "test_fused_qp.py::TestFusedMatchesVmap::test_mpc_batch",
    "test_sparse.py::TestSparseQPSolve",
    "test_families_device.py",  # long-budget device twins + oracle
    "test_qp.py::TestLinearSolverHardening::test_kkt_ldlt_solves_equality_heavy_f32",
    "test_scaling.py::TestCompSlackRescore::test_flag_eliminates_false_solved",
    "test_sparse.py::TestStripPreparation::test_cg_factor_carries_strips",
}


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX runs on a GPU (decided here, at
    run time, never while collecting)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on the card")


def pytest_collection_modifyitems(config, items):
    for item in items:
        nodeid = item.nodeid.replace("tests/", "")
        for pat in _SLOW_TESTS:
            if nodeid.startswith(pat) or ("::" in pat and pat in nodeid):
                item.add_marker(pytest.mark.slow)
                break
