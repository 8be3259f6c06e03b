"""Plain PyTorch oracles for the ported kernels (the allclose references).

Counterpart of ``repro.kernels.ref``: ``attention_ref`` (the plain
version of the flash attention kernel, and the dense attention the decode
kernels are checked against), ``rmsnorm_ref`` and ``gla_ref`` (the
O(S²) oracle of gated linear attention; the GLA kernel's plain version is
the chunked ``models.gla.chunked_gla``).

Three more follow a CUDA kernel's own algorithm on the CPU, for the
tests (nothing on a model path calls them): ``decode_split_ref`` (the
dense decode kernel's split partials merged in split order),
``paged_split_ref`` (the same through the paged kernel's page table) and
``gla_chunk_parallel_ref`` (the GLA kernel's chunk states, scan over
chunks and outputs, optionally with its operands rounded as its 3xTF32
tensor-core products round them).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["attention_ref", "rmsnorm_ref", "gla_ref", "cumsum_f32",
           "decode_split_ref", "paged_split_ref", "gla_chunk_parallel_ref",
           "tf32_round"]


def cumsum_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumsum along ``dim`` added left to right in f32: the
    order of the reference's ``jnp.cumsum`` on the CPU over the reduced
    configs' chunk of 16 steps (XLA blocks longer scans).  ``torch.cumsum``
    on the CPU accumulates in f64, and a GLA decay exp(c_t - c_s) of two
    large cumsums magnifies the difference (an f32 ulp of |c| ~ 150 is
    1.5e-5).  On the card ``torch.cumsum`` accumulates in f32 already, so
    it is used there: the loop would cost a launch a step."""
    x = x.float()
    if x.device.type != "cpu":
        return torch.cumsum(x, dim)
    out = [x.select(dim, 0)]
    for i in range(1, x.shape[dim]):
        out.append(out[-1] + x.select(dim, i))
    return torch.stack(out, dim=dim)


def attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Materialized-logits GQA attention, f32 softmax."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float() / math.sqrt(D)
    kf = k.float()
    vf = v.float()
    qg = qf.reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kf)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask[None, None, None], -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, vf)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Mean of squares in f32, ``x * rsqrt(var + eps) * scale``, cast
    back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def gla_ref(
    q: torch.Tensor,  # (B, S, H, dk)
    k: torch.Tensor,  # (B, S, H, dk)
    v: torch.Tensor,  # (B, S, H, dv)
    log_g: torch.Tensor,  # (B, S, H)  (<= 0)
    initial_state: Optional[torch.Tensor] = None,  # (B, H, dk, dv)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(S²) direct evaluation of gated linear attention:
    y_t = Σ_{s≤t} exp(c_t − c_s) (q_t·k_s) v_s + exp(c_t)·q_tᵀS₀."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    c = cumsum_f32(log_g, dim=1)  # (B, S, H)
    dmat = c[:, :, None, :] - c[:, None, :, :]  # (B, t, s, H)
    tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~tri[None, :, :, None], float("-inf"))
    att = torch.einsum("bthd,bshd->btsh", qf, kf) * torch.exp(dmat)
    y = torch.einsum("btsh,bshv->bthv", att, vf)
    S0 = (initial_state.float() if initial_state is not None
          else torch.zeros((B, H, dk, dv), dtype=torch.float32,
                           device=q.device))
    y = y + torch.einsum("bthd,bhdv->bthv", qf * torch.exp(c)[..., None], S0)
    cL = c[:, -1, :]
    k_decay = torch.exp(cL[:, None, :] - c)
    state = torch.exp(cL)[:, :, None, None] * S0 + torch.einsum(
        "bshd,bshv->bhdv", kf * k_decay[..., None], vf)
    return y.to(v.dtype), state


def decode_split_ref(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    kv_len,           # int or 0-d tensor: valid entries, clamped to S
    block_kv: int = 256,
) -> torch.Tensor:
    """Dense decode attention as ``csrc/decode_attention.cu`` computes it:
    each split of ``block_kv`` entries below ``kv_len`` gives a partial
    state (its max m, its sum l of exp(s - m), its acc = sum exp(s - m) v),
    and the partials merge in split order into acc / max(l, 1e-30).  Zeros
    at ``kv_len == 0``, as the kernel and ``flash_decode_pallas`` give."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    n = min(max(int(kv_len), 0), S)
    if n == 0:
        return torch.zeros_like(q)
    qg = q.reshape(B, KV, H // KV, D).float() / math.sqrt(D)
    out = torch.stack([_split_merge(qg[b], k[b, :n].float(),
                                    v[b, :n].float(), min(block_kv, S))
                       for b in range(B)])
    return out.reshape(B, H, D).to(q.dtype)


def _split_merge(qg, k, v, split):
    """softmax(qg . k^T) v for one sequence, qg (KV, G, D) scaled, k and
    v (n, KV, D) f32, as the decode kernels compute it: each split of
    ``split`` tokens gives a partial state (its max m, its sum l of
    exp(s - m), its acc = sum exp(s - m) v), and the partials merge in
    split order into acc / max(l, 1e-30)."""
    ms, ls, accs = [], [], []
    for t0 in range(0, k.shape[0], split):
        s = torch.einsum("kgd,skd->kgs", qg, k[t0:t0 + split])
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("kgs,skd->kgd", p, v[t0:t0 + split]))
    mx = torch.stack(ms).amax(dim=0)
    den = torch.zeros_like(mx)
    acc = torch.zeros_like(accs[0])
    for m, l_, a in zip(ms, ls, accs):  # split order
        w = torch.exp(m - mx)
        den = den + l_ * w
        acc = acc + a * w[..., None]
    return acc / den.clamp_min(1e-30)[..., None]


def paged_split_ref(
    q: torch.Tensor,           # (B, H, D)
    k_pages: torch.Tensor,     # (G, T, KV, D)
    v_pages: torch.Tensor,     # (G, T, KV, D)
    page_table: torch.Tensor,  # (B, MAXG) int32
    lengths: torch.Tensor,     # (B,) int32
    split_tokens: int,
) -> torch.Tensor:
    """Paged decode attention as ``csrc/paged_attention.cu`` computes it:
    row b's tokens below lengths[b], read through its page-table row, cut
    into splits of ``split_tokens``; each split's partial state merged in
    split order (``_split_merge``).  Zeros where a length is 0, as the
    kernel and ``paged_flash_decode_pallas`` give; NaN where a length is
    outside [0, MAXG * T] or a group the row reads has a page-table entry
    outside [0, G), as the kernel gives."""
    B, H, D = q.shape
    G, T, KV, _ = k_pages.shape
    maxg = page_table.shape[1]
    out = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    for b in range(B):
        n = int(lengths[b])
        if n == 0:
            continue
        groups = page_table[b, :-(-n // T)].long()
        if not 0 < n <= maxg * T or bool(((groups < 0) | (groups >= G))
                                         .any()):
            out[b] = float("nan")
            continue
        k = k_pages[groups].reshape(-1, KV, D)[:n].float()
        v = v_pages[groups].reshape(-1, KV, D)[:n].float()
        qg = q[b].reshape(KV, H // KV, D).float() / math.sqrt(D)
        out[b] = _split_merge(qg, k, v, split_tokens).reshape(H, D)
    return out.to(q.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` with all but the top 10 mantissa bits cleared: the bits a
    TF32 tensor-core product reads of an operand."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, tf32: Optional[str]):
    """a @ b in f32, with the operands rounded as ``tf32`` says: None
    keeps them, "1x" rounds each to TF32 once, "3x" splits each into
    hi + lo (both TF32) and sums lo.hi + hi.lo + hi.hi, the kernel's
    3xTF32 product."""
    if tf32 is None:
        return a @ b
    ah, bh = tf32_round(a), tf32_round(b)
    if tf32 == "1x":
        return ah @ bh
    if tf32 != "3x":
        raise ValueError(f"tf32={tf32!r}: None, '1x' or '3x'")
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def gla_chunk_parallel_ref(
    q: torch.Tensor,  # (B, S, H, dk)
    k: torch.Tensor,  # (B, S, H, dk)
    v: torch.Tensor,  # (B, S, H, dv)
    log_g: torch.Tensor,  # (B, S, H)  (<= 0)
    chunk: int = 128,
    tf32: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked GLA from a zero state as ``csrc/gla.cu`` computes it, in
    f32: (1) each chunk's own state dS_c = sum_s exp(c_L - c_s) k_s v_s^T
    and decay exp(c_L), c the chunk's inclusive cumsum; (2) the scan
    S_{c+1} = exp(c_L) S_c + dS_c from S_0 = 0, whose last is the final
    state; (3) y = exp(c_t) (q_t S_c) + ((q k^T) o masked decay) v.
    ``tf32`` rounds every product's operands as the tensor cores do
    (``_matmul``).  Returns (y in v's dtype, final state f32)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(x):  # (B, S, H, d) -> (nc, B, H, L, d), padded with zeros
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, nc, L, H, x.shape[-1]).permute(1, 0, 3, 2, 4)

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    gc = torch.nn.functional.pad(log_g.float(), (0, 0, 0, pad))
    c = cumsum_f32(gc.reshape(B, nc, L, H).permute(1, 0, 3, 2), dim=-1)
    cL = c[..., -1]                                    # (nc, B, H)
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()

    d_state = [_matmul((kc[i] * torch.exp(cL[i, ..., None] - c[i])[..., None]
                        ).transpose(-1, -2), vc[i], tf32)
               for i in range(nc)]                     # (1) chunk states
    state = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for i in range(nc):                                # (2) scan, (3) out
        inter = torch.exp(c[i])[..., None] * _matmul(qc[i], state, tf32)
        state = torch.exp(cL[i])[..., None, None] * state + d_state[i]
        dm = c[i][..., :, None] - c[i][..., None, :]
        att = _matmul(qc[i], kc[i].transpose(-1, -2), tf32)
        att = torch.where(tri, att * torch.exp(torch.where(tri, dm, 0.0)),
                          0.0)
        ys.append(inter + _matmul(att, vc[i], tf32))
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, nc * L, H, dv)
    return y[:, :S].to(v.dtype), state
