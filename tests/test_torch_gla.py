"""The port's gated linear attention against the reference, on the CPU.

Same numpy inputs (made from a seed) into ``repro``'s and
``repro_torch``'s functions:

* ``models.gla.chunked_gla`` and ``gla_step`` against the reference's;
* ``kernels.ref.gla_ref`` (the O(S²) oracle) against the reference's;
* ``kernels.ops.gla`` on CPU tensors (the CUDA kernel's plain version)
  against ``gla_pallas`` in interpret mode, at the shapes of
  ``tests/test_kernels.py::TestGLA`` (ragged S=70 included), in f32 and
  bf16, with q and k broadcast over the heads as Mamba2 passes them;
* ``kernels.ref.gla_chunk_parallel_ref`` (the CUDA kernel's algorithm:
  chunk states, a scan over chunks, outputs) against ``gla_pallas`` in
  interpret mode and ``chunked_gla``: one chunk, S < chunk, a ragged last
  chunk, q and k broadcast over the heads; with its operands rounded as
  the kernel's 3xTF32 tensor-core products round them, at the f32 GLA
  shapes ``chip_smoke.py`` phase 3 holds the kernel to, within the
  kernel's f32 bar there (2e-5 of max |ref| plus 2e-5 of |ref|);
* the chunk-invariance property of ``tests/test_kernels.py``.

Tolerances: the chunked core and the step against the reference's, f32,
2e-5 (the reference's own kernel-vs-core bar,
``TestGLA.test_matches_model_core``); against ``gla_pallas`` and for the
O(S²) oracle (sums over all S steps at once) the bars ``TestGLA`` holds
the Pallas kernel to against ``gla_ref``: f32 y 5e-5 and state 1e-4,
bf16 2e-2.
The port's cumsum adds left to right in f32 (``kernels.ref.cumsum_f32``),
as XLA's does on the CPU over up to 16 steps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.gla import gla_pallas
from repro.kernels.ref import gla_ref as jax_gla_ref
from repro.models.gla import chunked_gla as jax_chunked_gla
from repro.models.gla import gla_step as jax_gla_step
from repro_torch.kernels import gla as gl
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (cumsum_f32, gla_chunk_parallel_ref,
                                     gla_ref)
from repro_torch.models.gla import chunked_gla, gla_step

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=2e-5)
KERNEL_TOL = {"float32": (dict(rtol=5e-5, atol=5e-5),
                          dict(rtol=1e-4, atol=1e-4)),
              "bfloat16": (dict(rtol=2e-2, atol=2e-2),
                           dict(rtol=2e-2, atol=2e-2))}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, S, H, dk, dv, scale=0.3, shared_qk=False):
    rng = np.random.default_rng(seed)
    if shared_qk:  # one (B, S, dk) row per step, broadcast over the heads
        q = np.broadcast_to(rng.normal(size=(B, S, 1, dk)), (B, S, H, dk))
        k = np.broadcast_to(rng.normal(size=(B, S, 1, dk)), (B, S, H, dk))
    else:
        q = rng.normal(size=(B, S, H, dk))
        k = rng.normal(size=(B, S, H, dk))
    v = rng.normal(size=(B, S, H, dv))
    g = -np.abs(rng.normal(size=(B, S, H))) * scale
    return [np.ascontiguousarray(a).astype(np.float32) for a in (q, k, v, g)]


def _jax(arrs, dtype="float32"):
    jdt = DTYPES[dtype][0]
    q, k, v, g = arrs
    return (jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
            jnp.asarray(v).astype(jdt), jnp.asarray(g))


def _torch(arrs, dtype="float32", shared_qk=False):
    tdt = DTYPES[dtype][1]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs[:3])
    if shared_qk:  # the head broadcast as a stride-0 view, as Mamba2 has it
        q = q[:, :, :1].expand(q.shape)
        k = k[:, :, :1].expand(k.shape)
    return q, k, v, torch.from_numpy(arrs[3])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# the reference kernel tests' shapes (tests/test_kernels.py TestGLA)
SHAPES = [
    (1, 16, 1, 4, 4, 8),
    (2, 64, 3, 8, 16, 16),
    (1, 70, 2, 16, 8, 32),   # ragged
    (2, 128, 4, 32, 32, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,dk,dv,chunk", SHAPES)
def test_plain_version_matches_gla_pallas(dtype, B, S, H, dk, dv, chunk):
    arrs = _inputs(hash((B, S, H, dk, dv)) % 2**31, B, S, H, dk, dv)
    yj, sj = gla_pallas(*_jax(arrs, dtype), chunk=chunk, interpret=True)
    y, s = ops.gla(*_torch(arrs, dtype), chunk=chunk)
    assert y.dtype == DTYPES[dtype][1] and s.dtype == torch.float32
    ytol, stol = KERNEL_TOL[dtype]
    _close(y, yj, ytol)
    _close(s, sj, stol)


@pytest.mark.parametrize("B,S,H,dk,dv,chunk", SHAPES)
def test_chunked_gla_matches_reference(B, S, H, dk, dv, chunk):
    arrs = _inputs(1, B, S, H, dk, dv)
    rng = np.random.default_rng(2)
    s0 = rng.normal(size=(B, H, dk, dv)).astype(np.float32)
    yj, sj = jax_chunked_gla(*_jax(arrs), chunk=chunk,
                             initial_state=jnp.asarray(s0))
    y, s = chunked_gla(*_torch(arrs), chunk=chunk,
                       initial_state=torch.from_numpy(s0))
    _close(y, yj, F32)
    _close(s, sj, F32)


@pytest.mark.parametrize("B,S,H,dk,dv,chunk", SHAPES)
def test_gla_ref_matches_reference(B, S, H, dk, dv, chunk):
    arrs = _inputs(3, B, S, H, dk, dv)
    s0 = np.random.default_rng(4).normal(size=(B, H, dk, dv)).astype(
        np.float32)
    yj, sj = jax_gla_ref(*_jax(arrs), initial_state=jnp.asarray(s0))
    y, s = gla_ref(*_torch(arrs), initial_state=torch.from_numpy(s0))
    # sums over up to S=128 steps at once: TestGLA's slack for that
    ytol, stol = KERNEL_TOL["float32"]
    _close(y, yj, ytol)
    _close(s, sj, stol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_broadcast_qk_at_the_models_chunk(dtype):
    """Mamba2's q and k are (B, S, ds) rows broadcast over the heads; the
    ragged tail (S=70 at chunk 32) is masked, not read past the end."""
    arrs = _inputs(5, 2, 70, 4, 16, 32, shared_qk=True)
    yj, sj = gla_pallas(*_jax(arrs, dtype), chunk=32, interpret=True)
    q, k, v, g = _torch(arrs, dtype, shared_qk=True)
    assert q.stride(2) == 0 and k.stride(2) == 0
    y, s = ops.gla(q, k, v, g, chunk=32)
    ytol, stol = KERNEL_TOL[dtype]
    _close(y, yj, ytol)
    _close(s, sj, stol)


@pytest.mark.parametrize("tf32", [None, "3x"])
@pytest.mark.parametrize("B,S,H,dk,dv,chunk,shared_qk", [
    (2, 32, 3, 8, 16, 32, False),   # one chunk
    (1, 20, 2, 16, 8, 64, False),   # S < chunk
    (2, 70, 2, 16, 8, 32, False),   # a ragged last chunk
    (2, 70, 4, 16, 8, 32, True),    # Mamba2's broadcast q and k
], ids=["one-chunk", "short", "ragged", "broadcast"])
def test_chunk_parallel_ref_matches_gla_pallas(B, S, H, dk, dv, chunk,
                                               shared_qk, tf32):
    """The CUDA kernel's algorithm, exact or with 3xTF32 operands, against
    ``gla_pallas`` in interpret mode and against ``chunked_gla``."""
    arrs = _inputs(11, B, S, H, dk, dv, shared_qk=shared_qk)
    yj, sj = gla_pallas(*_jax(arrs), chunk=chunk, interpret=True)
    tq, tk, tv, tg = _torch(arrs, shared_qk=shared_qk)
    y, s = gla_chunk_parallel_ref(tq, tk, tv, tg, chunk=chunk, tf32=tf32)
    ytol, stol = KERNEL_TOL["float32"]
    _close(y, yj, ytol)
    _close(s, sj, stol)
    yc, sc = chunked_gla(tq, tk, tv, tg, chunk=chunk)
    _close(y, yc.numpy(), F32)
    _close(s, sc.numpy(), F32)


def _scaled_err(got, want, tol):
    """The largest error as a share of ``chip_smoke.py``'s GLA bar,
    tol * max |ref| + tol * |ref| (1.0 sits on the bar)."""
    w = want.float()
    return float(((got.float() - w).abs()
                  / (tol * w.abs().max() + tol * w.abs())).max())


@pytest.mark.parametrize("B,S,H,dk,dv,chunk,shared_qk", [
    (1, 16, 1, 4, 4, 8, False),
    (2, 64, 3, 8, 16, 16, False),
    (1, 70, 2, 16, 8, 32, False),
    (2, 128, 4, 32, 32, 64, False),
    (2, 1000, 4, 64, 32, 256, True),
    (1, 300, 2, 128, 128, 256, False),
    (1, 100, 2, 96, 40, 64, False),
    (1, 4096, 64, 64, 64, 256, True),  # Zamba2-1.2B's Mamba2 layer
], ids=["tiny", "small", "ragged", "d32", "broadcast-1000", "d128",
        "d96x40", "zamba2"])
def test_3xtf32_emulation_meets_the_f32_bar(B, S, H, dk, dv, chunk,
                                            shared_qk):
    """Operands rounded as the kernel's 3xTF32 products round them keep y
    and the final state within the f32 bar ``chip_smoke.py`` phase 3
    holds the kernel to against ``chunked_gla`` (2e-5 of max |ref| plus
    2e-5 of |ref|), at the phase's f32 shapes.  Single-pass TF32 goes
    over the bar at every one of them: the control that shows the bar
    tells the two apart.  ``pytest -s`` prints both shares of the bar."""
    arrs = _inputs(12, B, S, H, dk, dv, shared_qk=shared_qk)
    args = _torch(arrs, shared_qk=shared_qk)
    yc, sc = chunked_gla(*args, chunk=chunk)
    share = {}
    for mode in ("1x", "3x"):
        y, s = gla_chunk_parallel_ref(*args, chunk=chunk, tf32=mode)
        share[mode] = (_scaled_err(y, yc, 2e-5), _scaled_err(s, sc, 2e-5))
    print(f"share of the f32 bar (y, state): {share}")
    assert max(share["3x"]) <= 1.0
    assert max(share["1x"]) > 1.0


def test_gla_step_matches_reference_and_the_chunked_core():
    rng = np.random.default_rng(6)
    B, H, dk, dv = 2, 3, 8, 16
    q, k = (rng.normal(size=(B, H, dk)).astype(np.float32) for _ in "qk")
    v = rng.normal(size=(B, H, dv)).astype(np.float32)
    g = -np.abs(rng.normal(size=(B, H))).astype(np.float32)
    s0 = rng.normal(size=(B, H, dk, dv)).astype(np.float32)
    yj, sj = jax_gla_step(*(jnp.asarray(a) for a in (q, k, v, g, s0)))
    y, s = gla_step(*(torch.from_numpy(a) for a in (q, k, v, g, s0)))
    _close(y, yj, F32)
    _close(s, sj, F32)
    # a step from the zero state is the chunked core on one step
    yc, sc = chunked_gla(*(torch.from_numpy(a)[:, None] for a in (q, k, v, g)))
    y0, s0_ = gla_step(*(torch.from_numpy(a) for a in (q, k, v, g)),
                       torch.zeros(B, H, dk, dv))
    torch.testing.assert_close(yc[:, 0], y0, **F32)
    torch.testing.assert_close(sc, s0_, **F32)


def test_cumsum_adds_left_to_right_in_f32():
    """numpy's cumsum adds left to right; so does XLA's on the CPU over
    the reduced configs' chunk of 16 steps (longer scans it blocks)."""
    x = torch.from_numpy(-np.abs(np.random.default_rng(7).normal(
        size=(2, 300, 3))).astype(np.float32) * 5)
    want = np.cumsum(x.numpy(), axis=1, dtype=np.float32)
    np.testing.assert_array_equal(cumsum_f32(x, 1).numpy(), want)
    np.testing.assert_array_equal(
        cumsum_f32(x[:, :16], 1).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(x[:, :16].numpy()), axis=1)))


@given(S=st.integers(4, 60), chunk=st.sampled_from([4, 8, 16, 32]),
       seed=st.integers(0, 50))
@settings(max_examples=20, deadline=None)
def test_property_chunk_invariance(S, chunk, seed):
    """Output must not depend on the chunk size (tiling invariance): the
    plain version at any chunk against the O(S²) oracle, at the bars
    ``TestGLA`` holds the Pallas kernel to."""
    arrs = _inputs(seed, 1, S, 1, 8, 8, scale=0.5)
    y, s = ops.gla(*_torch(arrs), chunk=chunk)
    yr, sr = gla_ref(*_torch(arrs))
    torch.testing.assert_close(y, yr, rtol=5e-5, atol=5e-5)
    torch.testing.assert_close(s, sr, rtol=1e-4, atol=1e-4)


def test_plain_version_is_differentiable():
    """The CUDA kernel has no gradient (nor has gla_pallas); its plain
    version differentiates by autograd, with finite gradients."""
    q, k, v, g = _torch(_inputs(8, 1, 20, 2, 4, 4))
    for t in (q, k, v, g):
        t.requires_grad_()
    y, s = ops.gla(q, k, v, g, chunk=8)
    (y.square().sum() + s.sum()).backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v, g))


def test_smem_footprint_formula():
    """The shared memory the kernel's library reports is this formula
    (``chip_smoke.py`` holds the two equal on the card): the output
    kernel's block at a head group of two, two cumsums of the chunk
    rounded up to 64-step tiles, q and k tiles of 64 rows padded to 4
    mod 32 floats and two v tiles (or one S_c, rows padded to 8 mod 32);
    at the model's chunk and Zamba2's dk = dv = 64 three blocks fit an SM,
    and the largest head the kernel takes fits the H100's opt-in limit."""
    assert gl.smem_bytes(64, 64, 256) == 4 * (2 * 256 + 2 * 64 * 68
                                              + 2 * 64 * 68)
    assert 3 * gl.smem_bytes(64, 64, 256) <= 233_472
    assert gl.smem_bytes(gl.MAX_DIM, gl.MAX_DIM, gl.MAX_CHUNK) <= 232_448
    assert gl.smem_bytes(8, 8, 16) == 4 * (2 * 64 + 2 * 64 * 36
                                           + 2 * 64 * 68)
