"""Plain torch oracle for the flash attention kernel, the counterpart of the
reference package's ``flash_attention/ref.py``.  It casts where the
reference casts: scores leave the product in the working dtype and are then
cast to fp32; probabilities are cast back before the product with V."""
from __future__ import annotations

import math

import torch


def _scores(q, k, *, causal, window):
    """Masked fp32 scores [B,Hkv,G,Sq,Sk] (masked entries -1e30)."""
    B, Sq, Hq, d = q.shape
    _, Sk, Hkv, _ = k.shape
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, d)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(d)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return s.masked_fill(~mask, -1e30)


def attention_ref(
    q: torch.Tensor,  # [B,Sq,Hq,dh]
    k: torch.Tensor,  # [B,Sk,Hkv,dh]
    v: torch.Tensor,  # [B,Sk,Hkv,dv], dv <= dh (MLA's values are narrower)
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """[B,Sq,Hq,dv]: the function the kernels compute."""
    B, Sq, Hq, _ = q.shape
    p = torch.softmax(_scores(q, k, causal=causal, window=window), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v)
    return out.reshape(B, Sq, Hq, v.shape[-1])


def attention_lse_ref(
    q: torch.Tensor, k: torch.Tensor, *, causal: bool = True, window: int | None = None
) -> torch.Tensor:
    """The per-row logsumexp of the scaled, masked scores, fp32 [B,Hq,Sq]:
    what the kernel saves for its backward."""
    B, Sq, Hq, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal=causal, window=window), dim=-1)
    return lse.reshape(B, Hq, Sq)  # [B,Hkv,G,Sq] -> heads kvh*G+g in order


# --------------------------------------------------------------------------
# The fp32 kernels' arithmetic (variant "tf32x3"), for the tests on the CPU
# --------------------------------------------------------------------------
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits, the low 13 bits
    zero), to nearest with ties away from zero: ``cvt.rna.tf32.f32``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi), as the kernels' split pass
    and their staging of P and dS write them."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def einsum_tf32(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``einsum(eq, a, b)`` with each fp32 product a.b taken as the kernels
    take it on the tensor cores: a_hi.b_lo + a_lo.b_hi + a_hi.b_hi (three
    passes; each product of tf32 values is exact in fp32, the sums fp32), or
    a_hi.b_hi alone (one TF32 pass)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    if passes != 3:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bh)


def attention_tf32x3(
    q: torch.Tensor,  # [B,Sq,Hq,d] fp32
    k: torch.Tensor,  # [B,Sk,Hkv,d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    passes: int = 3,
) -> torch.Tensor:
    """Attention as the fp32 forward kernel computes it: S = Q.K^T in tf32
    products, the softmax in fp32 on the unnormalised exponentials, O =
    P.V in tf32 products, then divided by the row sums.  Used by tests
    only; the wrapper's CPU path is :func:`attention_ref`."""
    B, Sq, Hq, d = q.shape
    _, Sk, Hkv, _ = k.shape
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, d)
    s = einsum_tf32("bskgd,btkd->bkgst", qg, k.float(), passes) / math.sqrt(d)
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = einsum_tf32("bkgst,btkd->bskgd", p, v.float(), passes)
    out = out / p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, Hq, v.shape[-1])


# --------------------------------------------------------------------------
# The bf16 kernels over gathered rows (variant "wgmma_rows"), for the tests on
# the CPU: their row layout, their walks over tiles and their arithmetic
# --------------------------------------------------------------------------
ROWS = 64  # rows (or keys) of one consumer warpgroup's tile


def column_chunks(dh: int) -> int:
    """64-column chunks of the head dim padded to 16 (``wgmma_chunks``)."""
    return ((dh + 15) // 16 * 16 + 63) // 64


def fwd_keys(dvc: int) -> int:
    """Keys of the forward's tile at ``dvc`` 64-column chunks of the values
    (``fwd_keys``): 128 where O takes at most two chunks (the ping-pong
    forward, ``fwd_pingpong``), else 64."""
    return 128 if dvc <= 2 else 64


def fwd_pingpong(dvc: int) -> bool:
    """Whether the forward at ``dvc`` 64-column chunks of the values is the
    ping-pong kernel (``fwd_pingpong``: (1, 1), (2, 2) and MLA's (3, 2)),
    which issues a tile's S beside the last tile's P.V: O takes the last
    tile's P.V, then is rescaled to this tile's maximum."""
    return dvc <= 2


def pp_consumers(dc: int) -> int:
    """The most consumer warpgroups of the ping-pong forward at ``dc`` column
    chunks of the keys (``pp_consumers``): three (192-row blocks) at one
    chunk, else two."""
    return 3 if dc == 1 else 2


def pp_launch_consumers(dc: int, B: int, Sq: int, G: int, Hkv: int, sms: int = 132) -> int:
    """The consumer warpgroups a launch of the ping-pong forward takes
    (``launch_fwd_wgmma``): the most where their grid has a block for every
    SM of the card (132 on the H100), else two."""
    most = pp_consumers(dc)
    return most if -(-Sq * G // (most * ROWS)) * B * Hkv >= sms else 2


PP_GROUP_BYTES = 8 << 20  # pp_group_bytes: K and V of a group of the ping-pong grid's heads


def pp_heads_per_group(B: int, Sk: int, Hkv: int, dc: int, dvc: int,
                       group_bytes: int = PP_GROUP_BYTES) -> int:
    """kv heads of a group of the ping-pong forward's grid
    (``pp_heads_per_group``): as many as keep the group's K and V (Sk keys
    of dc + dvc 64-column chunks in bf16 each) within ``group_bytes``, at
    least one."""
    return max(1, min(B * Hkv, group_bytes // (Sk * (dc + dvc) * 64 * 2)))


def pp_block(i: int, n_rt: int, n_bh: int, hg: int, causal: bool) -> tuple[int, int] | None:
    """(row tile, b * Hkv + kvh) of the i-th block to start of the ping-pong
    forward's grid (hg, n_rt, ceil(n_bh / hg)), x first: kv head z * hg + x,
    row tile y counted from the heaviest under causal; None for the last
    group's blocks past the kv heads, which return at once."""
    x, y, z = i % hg, i // hg % n_rt, i // (hg * n_rt)
    bh = z * hg + x
    return None if bh >= n_bh else ((n_rt - 1 - y if causal else y), bh)


def dq_consumers(dc: int) -> int:
    return 2 if dc <= 3 else 1


def fused_bwd(dc: int, dvc: int) -> bool:
    """Whether the bf16 backward at dc and dvc column chunks runs the fused
    kernels (``fused_bwd``): (1, 1), (2, 2) and MLA's (3, 2)."""
    return (dc == dvc and dc <= 2) or (dc, dvc) == (3, 2)


def fused_item(t: int, BH: int, n_kb: int, hg: int) -> tuple[int, int]:
    """(bh, key block) of the fused kernel's ticket t (``fused_item``): the
    kv heads in groups of hg, each group's items key block first."""
    g, r = divmod(t, n_kb * hg)
    gs = min(hg, BH - g * hg)
    return g * hg + r % gs, r // gs


def fused_heads_per_group(B: int, Sq: int, Hq: int, Hkv: int, dh: int, dv: int) -> int:
    """The kv heads of a group of the fused kernel's tickets (``fused_item``),
    which the wrapper passes to the kernels: every head (key block major) but
    at MLA's (3, 2), the one pair where groups were measured, where as many
    as keep their Q, dO and fp32 dQ sums within 48 MiB of the L2, at most 16:
    8 heads at deepseek-v2's S 4,096, 16 at 1,024, 1 at 32,768.  On an H100
    80GB HBM3 at 700 W groups of 8 beat 2, 4 and 16 at S 4,096, 16 beat 8, 33
    and 66 at 1,024, and key block major over all 128 heads took 1.7 times as
    long at 4,096."""
    BH = B * Hkv
    if (column_chunks(dh), column_chunks(dv)) != (3, 2):
        return BH
    per_head = Sq * (Hq // Hkv) * ((dh + dv) * 2 + dh * 4)
    return max(1, min(BH, 16, (48 << 20) // per_head))


def kv_block_first(rt0: int, G: int, window: int, keys: int) -> int:
    """The first key block (of ``keys`` keys) whose row walk holds the row
    tile from rt0 (``kv_block_first``): the first to add to its dQ."""
    x = rt0 // G - window + 1 if window > 0 else 0
    return x // keys if x > 0 else 0


def kv_keys(dc: int) -> int:
    """Keys of a dK/dV block of the bf16 kernels at keys and values of equal
    chunks: 64 where the two warpgroups split the head columns
    (``kv_split``: from two chunks)."""
    return 128 if dc <= 1 else 64


def gather_rows(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """[B,S,Hq,dh] as the gather pass lays it out, [B*Hkv, S*G, dh]: row r =
    s*G + g of slab b*Hkv + kvh is position s of head kvh*G + g."""
    B, S, Hq, dh = x.shape
    G = Hq // Hkv
    return x.reshape(B, S, Hkv, G, dh).permute(0, 2, 1, 3, 4).reshape(B * Hkv, S * G, dh)


def key_walk(r0: int, rows: int, Sq: int, Sk: int, G: int, causal: bool, window: int,
             keys: int) -> list[int]:
    """First keys of the key tiles a block of ``rows`` rows from r0 walks
    (the forward and dQ kernels; window 0 is none)."""
    R = Sq * G
    p_lo, p_hi = r0 // G, (min(R, r0 + rows) - 1) // G
    key_lo = max(0, p_lo - window + 1) if window > 0 else 0
    key_hi = min(Sk - 1, p_hi) if causal else Sk - 1
    t_first = key_lo // keys
    n = key_hi // keys - t_first + 1 if key_hi >= key_lo else 0
    return [(t_first + i) * keys for i in range(n)]


def row_walk(k0: int, keys: int, Sq: int, Sk: int, G: int, causal: bool,
             window: int) -> list[int]:
    """First rows of the 64-row tiles the dK/dV block of ``keys`` keys from
    k0 walks."""
    R = Sq * G
    k_last = min(Sk, k0 + keys) - 1
    p_min = k0 if causal else 0
    p_max = min(Sq - 1, k_last + window - 1) if window > 0 else Sq - 1
    row_first = (min(p_min, Sq) * G // ROWS) * ROWS
    row_end = min(R, (p_max + 1) * G)
    n = (row_end - row_first + ROWS - 1) // ROWS if row_end > row_first else 0
    return [row_first + i * ROWS for i in range(n)]


def tile_invisible(key0: int, nkeys: int, pos_lo: int, pos_hi: int, Sk: int, causal: bool,
                   window: int) -> bool:
    """No (row, key) pair of a tile is visible: the forward and dQ kernels
    skip it."""
    key_last = min(Sk, key0 + nkeys) - 1
    return key0 >= Sk or (causal and key0 > pos_hi) or (window > 0 and key_last <= pos_lo - window)


def tile_needs_mask(key0: int, nkeys: int, pos_lo: int, pos_hi: int, Sk: int, causal: bool,
                    window: int) -> bool:
    """Some pair of a tile may be invisible; otherwise the kernels mask
    nothing."""
    return (key0 + nkeys > Sk or (causal and key0 + nkeys - 1 > pos_lo)
            or (window > 0 and key0 <= pos_hi - window))


def kv_tile_skip(kw0: int, tp_lo: int, tp_hi: int, Sk: int, causal: bool, window: int) -> bool:
    """The dK/dV kernel's test that no pair of a row tile (positions tp_lo
    to tp_hi) and its warpgroup's 64 keys from kw0 is visible."""
    kw_last = min(Sk, kw0 + ROWS) - 1
    return kw0 >= Sk or (causal and tp_hi < kw0) or (window > 0 and kw_last <= tp_lo - window)


def kv_tile_needs_mask(rt0: int, R: int, kw0: int, tp_lo: int, tp_hi: int, Sk: int,
                       causal: bool, window: int) -> bool:
    return (rt0 + ROWS > R or kw0 + ROWS > Sk or (causal and tp_lo < kw0 + ROWS - 1)
            or (window > 0 and tp_hi - window + 1 > kw0))


def _visible(kpos: torch.Tensor, qpos: torch.Tensor, Sk: int, causal: bool,
             window: int) -> torch.Tensor:
    ok = kpos < Sk
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    return ok


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _padded(x: torch.Tensor, n: int) -> torch.Tensor:
    """[BH, rows, dh] with zero rows appended up to n: what TMA reads past
    the edge."""
    pad = n - x.shape[1]
    return torch.cat([x, x.new_zeros(x.shape[0], pad, x.shape[2])], 1) if pad > 0 else x


def _slabs(x: torch.Tensor) -> torch.Tensor:
    """k or v [B,Sk,Hkv,dh] as [B*Hkv, Sk, dh] in fp32."""
    B, Sk, Hkv, dh = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(B * Hkv, Sk, dh)


def attention_rows_fwd(
    q: torch.Tensor,  # [B,Sq,Hq,d] bf16
    k: torch.Tensor,  # [B,Sk,Hkv,d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    p_hilo: bool = False,
    residual: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The forward as the wgmma_rows kernel computes it (and the wgmma one,
    over the caller's rows): over the gathered rows, block by block (128
    rows, two warpgroups of 64; ``pp_launch_consumers`` of them in the
    ping-pong kernel), each warpgroup over the key tiles its block
    walks and does not skip, the mask applied only where ``tile_needs_mask``
    says so, an online softmax, P rounded to bf16 for P.V, and, where the
    ping-pong kernel runs (``fwd_pingpong``), each tile's P.V added before O
    is rescaled to the next tile's maximum.  Returns (out [B,Sq,Hq,dv] bf16,
    lse fp32 [B,Hq,Sq]).
    ``p_hilo`` takes P into P.V as hi + lo bf16 instead, and ``residual``
    returns o_lo [B,Sq,Hq,dv] bf16 too, the fp32 output less out: a forward
    that would let the backward take D from its output (studied, not
    built).  Used by tests and studies only."""
    B, Sq, Hq, dh = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    G, w = Hq // Hkv, window or 0
    dvc = column_chunks(dv)
    R, keys = Sq * G, fwd_keys(dvc)
    pingpong = fwd_pingpong(dvc)
    nc = pp_launch_consumers(column_chunks(dh), B, Sq, G, Hkv) if pingpong else 2
    block = nc * ROWS
    scale = 1.0 / math.sqrt(dh)
    pv = _hilo if p_hilo else _bf16
    qr = _padded(gather_rows(q.float(), Hkv), R + 2 * ROWS)
    kr, vr = (_padded(_slabs(x), Sk + keys) for x in (k, v))
    out = torch.zeros(B * Hkv, R, dv)
    lse = torch.full((B * Hkv, R), -math.inf)
    for r0 in range(0, R, block):
        tiles = key_walk(r0, block, Sq, Sk, G, causal, w, keys)
        for rw0 in range(r0, min(r0 + block, R), ROWS):
            n = min(R, rw0 + ROWS) - rw0
            wp_lo, wp_hi = rw0 // G, (rw0 + n - 1) // G
            qpos = (torch.arange(rw0, rw0 + ROWS) // G)[:, None]
            m = torch.full((B * Hkv, ROWS), -math.inf)
            l = torch.zeros(B * Hkv, ROWS)
            acc = torch.zeros(B * Hkv, ROWS, dv)
            pending = None  # ping-pong: the last tile's P . V, added when the next S is issued
            for t0 in tiles:
                # skipped; the ping-pong kernel issues such a tile and its
                # mask takes every key (P 0, alpha 1): the same sums
                if tile_invisible(t0, keys, wp_lo, wp_hi, Sk, causal, w):
                    if pending is not None:
                        acc, pending = acc + pending, None
                    continue
                s = torch.einsum("brd,btd->brt", qr[:, rw0:rw0 + ROWS],
                                 kr[:, t0:t0 + keys]) * scale
                if tile_needs_mask(t0, keys, wp_lo, wp_hi, Sk, causal, w):
                    ok = _visible(torch.arange(t0, t0 + keys)[None, :], qpos, Sk, causal, w)
                    s = s.masked_fill(~ok, -math.inf)
                m_new = torch.maximum(m, s.amax(-1))
                m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp(m - m_use)
                p = torch.exp(s - m_use[..., None])
                l = l * alpha + p.sum(-1)
                pv_t = torch.einsum("brt,btd->brd", pv(p), vr[:, t0:t0 + keys])
                if pingpong:  # O += the last tile's P . V, then O *= alpha
                    if pending is not None:
                        acc = acc + pending
                    acc, pending = acc * alpha[..., None], pv_t
                else:
                    acc = acc * alpha[..., None] + pv_t
                m = m_new
            if pending is not None:
                acc = acc + pending
            seen = l > 0
            out[:, rw0:rw0 + n] = torch.where(seen[..., None], acc / l.clamp_min(1e-30)[..., None],
                                              0.0)[:, :n]
            lse[:, rw0:rw0 + n] = torch.where(seen, m + torch.log(l.clamp_min(1e-30)),
                                              -math.inf)[:, :n]
    out = out.reshape(B, Hkv, Sq, G, dv).permute(0, 2, 1, 3, 4).reshape(B, Sq, Hq, dv)
    lse = lse.reshape(B, Hkv, Sq, G).permute(0, 1, 3, 2).reshape(B, Hq, Sq)
    o = out.to(q.dtype)
    return (o, lse, (out - o.float()).to(q.dtype)) if residual else (o, lse)


def _hilo(x: torch.Tensor) -> torch.Tensor:
    """x as the sum of its hi and lo bf16 fragments: hi = bf16(x), lo =
    bf16(x - hi)."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def attention_rows_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    dout: torch.Tensor, *, causal: bool = True, window: int | None = None,
    single_rounding: bool = False, o_lo: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward as the bf16 kernels compute it (``wgmma_rows``, and
    ``wgmma`` over the caller's rows in place of the gathered copy), values
    ``dv`` wide.  D = rowsum(P * dP) is summed in fp32 over the 64-key tiles
    of each 64 rows, in order (the delta kernel's walk, or the dQ kernel's
    first).  The dK/dV blocks (``kv_keys`` keys) walk their 64-row tiles and
    add P^T . dO and dS^T . Q with P^T and dS^T as hi + lo bf16.  dQ: where
    the fused kernels take the shape (``fused_bwd``), each consumer
    warpgroup's partial bf16(dS) . K over its 64 keys, in fp32, the two of a
    key block added in order, is added to its row tile's fp32 sum in
    increasing key order, and dq is scale x the sum; else the dQ
    kernel's blocks (128 rows, or 64 at dh above 192) walk their 64-key
    tiles a second time and add bf16(dS) . K.  ``single_rounding`` takes the
    cheaper arithmetic instead (D = rowsum(dO * O) from the bf16 output, P^T
    and dS^T rounded once to bf16), which misses TOL at wide groups and at
    spread scores; ``o_lo`` (the forward's fp32 residual in bf16,
    ``attention_rows_fwd(residual=True)``) takes D = rowsum(dO * (out +
    o_lo)) from the output instead of the walk, the rest as the kernels.
    Returns (dq, dk, dv) bf16.  Used by tests and studies only."""
    B, Sq, Hq, dh = q.shape
    Sk, Hkv, dvw = k.shape[1], k.shape[2], v.shape[-1]
    G, w = Hq // Hkv, window or 0
    R, dc = Sq * G, column_chunks(dh)
    fused = fused_bwd(dc, column_chunks(dvw))
    BH, scale = B * Hkv, 1.0 / math.sqrt(dh)
    op = _bf16 if single_rounding else _hilo  # the A operands of dV and dK
    qr, dor = (_padded(gather_rows(x.float(), Hkv), R + 2 * ROWS) for x in (q, dout))
    kr, vr = (_padded(_slabs(x), Sk + 2 * ROWS) for x in (k, v))
    L = _padded(lse.reshape(B, Hkv, G, Sq).permute(0, 1, 3, 2).reshape(BH, R, 1),
                R + 2 * ROWS)[..., 0]
    L = torch.where(torch.isfinite(L), L, 0.0)
    walk = not single_rounding and o_lo is None  # D summed over the keys
    if single_rounding:
        D = (_padded(gather_rows(out.float(), Hkv), R + 2 * ROWS) * dor).sum(-1)
    elif o_lo is not None:
        D = (_padded(gather_rows(out.float() + o_lo.float(), Hkv), R + 2 * ROWS) * dor).sum(-1)
    else:
        D = torch.zeros(BH, R + 2 * ROWS)

    def products(r0, t0, nk):
        """S = Q . K^T and dP = dO . V^T of 64 rows from r0 and nk keys from t0."""
        s = torch.einsum("brd,btd->brt", qr[:, r0:r0 + ROWS], kr[:, t0:t0 + nk]) * scale
        dp = torch.einsum("brd,btd->brt", dor[:, r0:r0 + ROWS], vr[:, t0:t0 + nk])
        return s, dp

    # D where the kernels sum it, and dQ by the dQ kernel's second walk
    dq = torch.zeros(BH, R, dh)
    rows = dq_consumers(dc) * ROWS
    for r0 in range(0, R, rows):
        tiles = key_walk(r0, rows, Sq, Sk, G, causal, w, ROWS)
        for rw0 in range(r0, min(r0 + rows, R), ROWS):
            n = min(R, rw0 + ROWS) - rw0
            wp_lo, wp_hi = rw0 // G, (rw0 + n - 1) // G
            qpos = (torch.arange(rw0, rw0 + ROWS) // G)[:, None]
            live = [t0 for t0 in tiles
                    if not tile_invisible(t0, ROWS, wp_lo, wp_hi, Sk, causal, w)]

            def probs(t0, s):
                p = torch.exp(s - L[:, rw0:rw0 + ROWS, None])
                if tile_needs_mask(t0, ROWS, wp_lo, wp_hi, Sk, causal, w):
                    ok = _visible(torch.arange(t0, t0 + ROWS)[None, :], qpos, Sk, causal, w)
                    p = p.masked_fill(~ok, 0.0)
                return p

            if walk:
                d = torch.zeros(BH, ROWS)
                for t0 in live:
                    s, dp = products(rw0, t0, ROWS)
                    d = d + (probs(t0, s) * dp).sum(-1)
                D[:, rw0:rw0 + ROWS] = d
            if fused:
                continue
            acc = torch.zeros(BH, ROWS, dh)
            for t0 in live:
                s, dp = products(rw0, t0, ROWS)
                ds = probs(t0, s) * (dp - D[:, rw0:rw0 + ROWS, None])
                acc = acc + torch.einsum("brt,btd->brd", _bf16(ds), kr[:, t0:t0 + ROWS])
            dq[:, rw0:rw0 + n] = (acc * scale)[:, :n]

    # dK and dV, and where fused each key block's partials of dQ
    dk, dv = torch.zeros(BH, Sk, dh), torch.zeros(BH, Sk, dvw)
    dq_sum = torch.zeros(BH, R + 2 * ROWS, dh)
    keys = kv_keys(dc)
    for k0 in range(0, Sk, keys):
        tiles = row_walk(k0, keys, Sq, Sk, G, causal, w)
        slices = range(k0, k0 + keys, ROWS)  # a consumer warpgroup's 64 keys each
        kacc = [torch.zeros(BH, ROWS, dh) for _ in slices]
        vacc = [torch.zeros(BH, ROWS, dvw) for _ in slices]
        for rt0 in tiles:
            tp_lo, tp_hi = rt0 // G, (min(R, rt0 + ROWS) - 1) // G
            parts = []
            for i, kw0 in enumerate(slices):
                if kv_tile_skip(kw0, tp_lo, tp_hi, Sk, causal, w):
                    parts.append(torch.zeros(BH, ROWS, ROWS))
                    continue
                kpos = torch.arange(kw0, kw0 + ROWS)[:, None]
                s, dp = products(rt0, kw0, ROWS)
                p = torch.exp(s - L[:, rt0:rt0 + ROWS, None])
                if kv_tile_needs_mask(rt0, R, kw0, tp_lo, tp_hi, Sk, causal, w):
                    r = torch.arange(rt0, rt0 + ROWS)
                    ok = (r < R)[None, :] & _visible(kpos, (r // G)[None, :], Sk, causal, w)
                    p = p.masked_fill(~ok.T, 0.0)
                ds = p * (dp - D[:, rt0:rt0 + ROWS, None])
                vacc[i] = vacc[i] + torch.einsum("brt,brd->btd", op(p), dor[:, rt0:rt0 + ROWS])
                kacc[i] = kacc[i] + torch.einsum("brt,brd->btd", op(ds), qr[:, rt0:rt0 + ROWS])
                parts.append(ds)
            if fused:  # each slice's partial, added in slice order, then in key order
                part = None
                for kw0, ds in zip(slices, parts):
                    p_ = torch.einsum("brt,btd->brd", _bf16(ds), kr[:, kw0:kw0 + ROWS])
                    part = p_ if part is None else part + p_
                dq_sum[:, rt0:rt0 + ROWS] += part
        for i, kw0 in enumerate(slices):
            n = min(Sk, kw0 + ROWS) - kw0
            if n > 0:
                dk[:, kw0:kw0 + n] = (kacc[i] * scale)[:, :n]
                dv[:, kw0:kw0 + n] = vacc[i][:, :n]
    if fused:
        dq = dq_sum[:, :R] * scale

    dq = dq.reshape(B, Hkv, Sq, G, dh).permute(0, 2, 1, 3, 4).reshape(B, Sq, Hq, dh)
    dk = dk.reshape(B, Hkv, Sk, dh).permute(0, 2, 1, 3)
    dv = dv.reshape(B, Hkv, Sk, dvw).permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
