"""Plain PyTorch versions of the kernels.

These are the semantics of record for the port's CUDA kernels, and the
path a CPU tensor takes: ``kernels/ops.py`` sends CPU inputs here and
CUDA inputs to the kernels, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.  They mirror
``repro/kernels/ref.py`` (``attention_ref``, ``attention_streaming_ref``,
``paged_attention_ref`` in both layouts, ``chunked_prefill_paged_ref``,
``ssd_scan_ref``, ``ssd_decode_step_ref``) and compute scores and
states in f32.  ``attention_fwd_lse_ref`` and ``attention_bwd_ref`` are
the plain versions of the dense prefill's training pair (forward with
its LSE, and the backward), which the reference does not have: its
``jax.grad`` differentiates ``attention_ref`` itself.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, H, D] by repeating each KV head."""
    hkv = k.shape[2]
    if hkv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // hkv, dim=2)


def attention_ref(
    q: torch.Tensor,              # [B, Sq, H, Dq]
    k: torch.Tensor,              # [B, Skv, Hkv, Dq]
    v: torch.Tensor,              # [B, Skv, Hkv, Dv]
    *,
    causal: bool = True,
    q_offset: int = 0,
    sliding_window: int | None = None,
    lengths: torch.Tensor | None = None,   # [B] valid kv length per row
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Multi-head attention with GQA, a causal offset and a sliding window.

    ``q_offset`` is the absolute position of ``q[:, 0]`` within the kv
    sequence; with ``sliding_window`` the query at position p sees keys in
    ``(p - window, p]``.  Returns ``[B, Sq, H, Dv]`` in q's dtype."""
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    skv = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    dev = q.device
    q_pos = torch.arange(sq, device=dev)[:, None] + q_offset
    kv_pos = torch.arange(skv, device=dev)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= kv_pos <= q_pos
    if sliding_window is not None:
        mask &= kv_pos > q_pos - sliding_window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    if lengths is not None:
        valid = kv_pos < lengths.to(dev)[:, None, None, None]
        logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


STREAMING_KV_THRESHOLD = 8192
STREAMING_BLOCK_K = 2048


def _visible(sq: int, k0: int, k1: int, q_offset: int, causal: bool,
             sliding_window: int | None, device) -> torch.Tensor:
    """[Sq, k1 - k0] bool: key ``k0 + j`` is visible to query ``i`` (the
    mask of ``attention_ref``)."""
    q_pos = torch.arange(sq, device=device)[:, None] + q_offset
    kv_pos = torch.arange(k0, k1, device=device)[None, :]
    mask = torch.ones((sq, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos <= q_pos
    if sliding_window is not None:
        mask &= kv_pos > q_pos - sliding_window
    return mask


def attention_fwd_lse_ref(
    q: torch.Tensor,              # [B, Sq, H, Dq]
    k: torch.Tensor,              # [B, Skv, Hkv, Dq]
    v: torch.Tensor,              # [B, Skv, Hkv, Dv]
    *,
    causal: bool = True,
    q_offset: int = 0,
    sliding_window: int | None = None,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``attention_ref`` and the natural-log logsumexp of each row's
    scaled, masked scores: ``(out [B, Sq, H, Dv] in q's dtype, lse [B, H,
    Sq] f32)``.  A row with no visible key has ``lse = -inf`` and an output
    of zeros, as the kernel writes it (``attention_ref`` would average
    every value there).  From ``STREAMING_KV_THRESHOLD`` keys on it streams
    over key blocks, as ``attention_streaming_ref`` does."""
    if k.shape[1] >= STREAMING_KV_THRESHOLD:
        return _streaming(q, k, v, causal=causal, q_offset=q_offset,
                          sliding_window=sliding_window,
                          softmax_scale=softmax_scale,
                          block_k=STREAMING_BLOCK_K)
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    kr, vr = _repeat_kv(k, h), _repeat_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * scale
    mask = _visible(sq, 0, k.shape[1], q_offset, causal, sliding_window,
                    q.device)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    seen = mask.any(-1)                                          # [Sq]
    lse = torch.where(seen, torch.logsumexp(logits, dim=-1), -torch.inf)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
    out = torch.where(seen[None, :, None, None], out, torch.zeros_like(out))
    return out, lse


def attention_bwd_ref(
    q: torch.Tensor,              # [B, Sq, H, Dq]
    k: torch.Tensor,              # [B, Skv, Hkv, Dq]
    v: torch.Tensor,              # [B, Skv, Hkv, Dv]
    out: torch.Tensor,            # [B, Sq, H, Dv] the forward's output
    lse: torch.Tensor,            # [B, H, Sq] f32 the forward's LSE
    d_out: torch.Tensor,          # [B, Sq, H, Dv]
    *,
    causal: bool = True,
    q_offset: int = 0,
    sliding_window: int | None = None,
    softmax_scale: float | None = None,
    block_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of the dense prefill by the flash-backward algebra,
    in f32, each cast to its input's dtype: ``P = exp(S - lse)``, ``delta
    = rowsum(dO o O)``, ``dS = P o (dO.V^T - delta)``, ``dV = P^T.dO``,
    ``dK = scale dS^T.Q``, ``dQ = scale dS.K``, dK and dV summed over each
    group of ``H / Hkv`` query heads.  A row with ``lse = -inf`` (no
    visible key) gets zero gradients.  Keys are taken in blocks of
    ``block_k`` (all at once below ``STREAMING_KV_THRESHOLD`` unless
    given), so the score matrix is never larger than one block."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv_dim = v.shape[-1]
    rep = h // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if block_k is None:
        block_k = (STREAMING_BLOCK_K if skv >= STREAMING_KV_THRESHOLD
                   else max(skv, 1))
    q32, do32 = q.float(), d_out.float()
    delta = (do32 * out.float()).sum(-1).transpose(1, 2)        # [B, H, Sq]
    seen = torch.isfinite(lse)
    lse0 = torch.where(seen, lse, 0.0)[..., None]
    dq = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, skv, block_k):
        k1 = min(skv, k0 + block_k)
        kb = _repeat_kv(k[:, k0:k1], h).float()
        vb = _repeat_kv(v[:, k0:k1], h).float()
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb) * scale
        mask = _visible(sq, k0, k1, q_offset, causal, sliding_window,
                        q.device)[None, None] & seen[..., None]
        p = torch.where(mask, torch.exp(torch.where(mask, s - lse0, 0.0)),
                        0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", do32, vb)
        ds = p * (dp - delta[..., None])
        dv_h = torch.einsum("bhqk,bqhd->bkhd", p, do32)
        dk_h = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kb) * scale
        n = k1 - k0
        dks.append(dk_h.reshape(b, n, hkv, rep, d).sum(3))
        dvs.append(dv_h.reshape(b, n, hkv, rep, dv_dim).sum(3))
    dk = (torch.cat(dks, 1) if dks
          else torch.zeros_like(k, dtype=torch.float32))
    dv = (torch.cat(dvs, 1) if dvs
          else torch.zeros_like(v, dtype=torch.float32))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_streaming_ref(
    q: torch.Tensor,              # [B, Sq, H, Dq]
    k: torch.Tensor,              # [B, Skv, Hkv, Dq]
    v: torch.Tensor,              # [B, Skv, Hkv, Dv]
    *,
    causal: bool = True,
    q_offset: int = 0,
    sliding_window: int | None = None,
    softmax_scale: float | None = None,
    block_k: int = STREAMING_BLOCK_K,
) -> torch.Tensor:
    """``attention_ref``'s function with an online softmax over key
    blocks of ``block_k``: the (Sq x Skv) score matrix is never built,
    only one (Sq x block_k) block at a time, in f32.  The last block is
    zero-padded and its padding masked.  Returns ``[B, Sq, H, Dv]`` in
    q's dtype."""
    return _streaming(q, k, v, causal=causal, q_offset=q_offset,
                      sliding_window=sliding_window,
                      softmax_scale=softmax_scale, block_k=block_k,
                      with_lse=False)[0]


def _streaming(q, k, v, *, causal, q_offset, sliding_window, softmax_scale,
               block_k, with_lse: bool = True):
    """The online softmax of ``attention_streaming_ref``; with
    ``with_lse`` a row with no visible key gives zeros and ``lse = -inf``
    (``attention_fwd_lse_ref``'s contract), else the streaming output as
    it was.  Returns ``(out, lse or None)``."""
    b, sq, h, d = q.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    dev = q.device
    q32 = q.float()
    q_pos = torch.arange(sq, device=dev)[:, None] + q_offset
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=dev)
    for k0 in range(0, skv, block_k):
        kb = _repeat_kv(k[:, k0:k0 + block_k], h).float()
        vb = _repeat_kv(v[:, k0:k0 + block_k], h).float()
        pad = block_k - kb.shape[1]
        if pad:
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb) * scale
        k_pos = torch.arange(k0, k0 + block_k, device=dev)[None, :]
        mask = (k_pos < skv).expand(sq, block_k)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if sliding_window is not None:
            mask = mask & (k_pos > q_pos - sliding_window)
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    if not with_lse:
        return out.transpose(1, 2).to(q.dtype), None
    seen = _visible(sq, 0, skv, q_offset, causal, sliding_window,
                    dev).any(-1)                                   # [Sq]
    lse = torch.where(seen, m + torch.log(l), -torch.inf)
    out = torch.where(seen[None, None, :, None], out, 0.0)
    return out.transpose(1, 2).to(q.dtype), lse


def paged_attention_ref(
    q: torch.Tensor,              # [B, H, D] one decode query per sequence
    k_pages: torch.Tensor,        # [B, P, page, Hkv, D] or pool [N, page, Hkv, D]
    v_pages: torch.Tensor,        # same layout as k_pages
    lengths: torch.Tensor,        # [B] valid tokens in the cache
    *,
    softmax_scale: float | None = None,
    block_tables: torch.Tensor | None = None,   # [B, P] page ids
    return_lse: bool = False,
    out_dtype: torch.dtype | None = None,
):
    """Decode attention over a block-paged KV cache (one new token).

    Without ``block_tables`` the pages are the contiguous per-sequence
    list ``[B, P, page, Hkv, D]``; with them, k/v are a shared pool
    ``[N, page, Hkv, D]`` and each sequence's pages come from its table
    row.  GQA is contracted per KV-head group.  A row with
    ``lengths == 0`` returns zeros.  With ``return_lse`` it returns
    ``(out, lse)``: ``lse`` [B, H] f32 is each head's natural-log
    log-sum-exp of its valid scaled scores, -inf at ``lengths == 0``;
    ``out`` is the same as without.  ``out_dtype`` f32 from bf16 inputs
    weighs V by the f32 probabilities and sums in f32, as the kernel's f32
    output does, with nothing rounded to bf16."""
    if block_tables is not None:
        k_pages = k_pages[block_tables.long()]
        v_pages = v_pages[block_tables.long()]
    b, p, page, hkv, d = k_pages.shape
    dv = v_pages.shape[-1]
    h = q.shape[1]
    rep = h // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    k = k_pages.reshape(b, p * page, hkv, d)
    v = v_pages.reshape(b, p * page, hkv, dv)
    qg = q.reshape(b, hkv, rep, d)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k).float() * scale
    lengths = lengths.to(q.device)
    valid = (torch.arange(p * page, device=q.device)[None, None, None, :]
             < lengths[:, None, None, None])
    s = torch.where(valid, s, NEG_INF)
    if out_dtype in (None, v.dtype):
        probs = torch.softmax(s, dim=-1).to(v.dtype)
    else:
        probs, v = torch.softmax(s, dim=-1), v.to(out_dtype)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, v).reshape(b, h, dv)
    any_valid = (lengths > 0)[:, None, None]
    out = torch.where(any_valid, out, torch.zeros_like(out))
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1).reshape(b, h)
    return out, torch.where(any_valid[:, :, 0], lse, -torch.inf)


def chunked_prefill_paged_ref(
    q: torch.Tensor,              # [B, Sq, H, D] one prefill chunk per row
    k_pool: torch.Tensor,         # [N, page, Hkv, D] shared page pool
    v_pool: torch.Tensor,         # [N, page, Hkv, Dv]
    lengths: torch.Tensor,        # [B] total valid kv tokens
    block_tables: torch.Tensor,   # [B, P] page ids into the pool
    q_offsets: torch.Tensor,      # [B] absolute position of q[:, 0]
    *,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Chunked prefill over a paged KV cache.

    Row ``b``'s queries sit at positions ``q_offsets[b] + i`` and attend
    causally over the first ``lengths[b]`` tokens of the sequence, read
    through its block table.  Query rows with no visible key return
    zeros."""
    b, sq, h, d = q.shape
    _, page, hkv, dv = v_pool.shape
    p = block_tables.shape[1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    rep = h // hkv
    bt = block_tables.long()
    k = k_pool[bt].reshape(b, p * page, hkv, d)
    v = v_pool[bt].reshape(b, p * page, hkv, dv)
    qg = q.reshape(b, sq, hkv, rep, d)
    s = torch.einsum("bqgrd,bsgd->bgrqs", qg, k).float() * scale
    dev = q.device
    q_pos = q_offsets.to(dev)[:, None] + torch.arange(sq, device=dev)[None, :]
    k_pos = torch.arange(p * page, device=dev)[None, :]
    mask = ((k_pos[:, None, :] <= q_pos[..., None])
            & (k_pos[:, None, :] < lengths.to(dev)[:, None, None]))
    s = torch.where(mask[:, None, None], s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqs,bsgd->bqgrd", probs, v).reshape(b, sq, h, dv)
    row_valid = mask.any(dim=-1)[..., None, None]
    return torch.where(row_valid, out, torch.zeros_like(out))


def ssd_scan_ref(
    x: torch.Tensor,       # [B, L, H, P]  inputs per head
    dt: torch.Tensor,      # [B, L, H]     softplus'd step, f32
    a: torch.Tensor,       # [H]           negative decay rate, f32
    b_mat: torch.Tensor,   # [B, L, G, N]  input projection (B)
    c_mat: torch.Tensor,   # [B, L, G, N]  output projection (C)
    *,
    chunk_size: int = 64,
    initial_state: torch.Tensor | None = None,   # [B, H, P, N] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD (state-space duality) chunked scan.

    Returns ``(y [B, L, H, P] in x's dtype, final_state [B, H, P, N]
    f32)``.  Quadratic within a chunk, sequential over chunks; the G
    groups share B/C across H // G heads.  ``L`` must be a multiple of
    ``chunk_size``."""
    bsz, seqlen, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    assert seqlen % chunk_size == 0, "pad sequence to a chunk multiple"
    nc = seqlen // chunk_size
    rep = h // g
    b_h = torch.repeat_interleave(b_mat, rep, dim=2).float()   # [B, L, H, N]
    c_h = torch.repeat_interleave(c_mat, rep, dim=2).float()
    log_decay = a.float()[None, None, :] * dt.float()           # [B, L, H]
    xdt = x.float() * dt.float()[..., None]                     # [B, L, H, P]

    def to_chunks(t):
        return t.reshape((bsz, nc, chunk_size) + tuple(t.shape[2:]))

    xc, bc, cc, ld = map(to_chunks, (xdt, b_h, c_h, log_decay))
    seg = torch.cumsum(ld, dim=2)                 # [B, C, Q, H]
    total = seg[:, :, -1, :]                      # [B, C, H]

    # intra-chunk: y[q] += sum_{t<=q} C[q].B[t] exp(seg[q]-seg[t]) x[t]dt[t]
    scores = torch.einsum("bcqhn,bcthn->bchqt", cc, bc)
    rel = (seg[:, :, :, None, :] - seg[:, :, None, :, :]).movedim(-1, 2)
    causal = torch.tril(torch.ones(chunk_size, chunk_size, dtype=torch.bool,
                                   device=x.device))
    # select, never multiply by a 0/1 mask: exp(rel) overflows above the
    # diagonal, and inf * 0 is NaN
    decay = torch.where(causal, torch.exp(rel), 0.0)
    y_diag = torch.einsum("bchqt,bcthp->bcqhp", scores * decay, xc)

    # each chunk's own state contribution, then the carry across chunks
    state_decay = torch.exp(total[:, :, None, :] - seg)         # [B, C, Q, H]
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          bc * state_decay[..., None], xc)
    if initial_state is None:
        s = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    else:
        s = initial_state.float()
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * torch.exp(total[:, c])[..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                      # [B, C, H, P, N]

    # off-diagonal: y[q] += exp(seg[q]) C[q] . S_in
    y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                         cc * torch.exp(seg)[..., None], prev_states)
    y = (y_diag + y_off).reshape(bsz, seqlen, h, p)
    return y.to(x.dtype), s


def ssd_scan_bwd_ref(
    x: torch.Tensor,       # [B, L, H, P]
    dt: torch.Tensor,      # [B, L, H] f32
    a: torch.Tensor,       # [H] f32
    b_mat: torch.Tensor,   # [B, L, G, N]
    c_mat: torch.Tensor,   # [B, L, G, N]
    initial_state: torch.Tensor | None,   # [B, H, P, N] f32 or None
    dy: torch.Tensor,      # [B, L, H, P] the cotangent of y
    d_final: torch.Tensor | None,         # [B, H, P, N] f32 or None
    chunk_size: int,
) -> tuple[torch.Tensor, ...]:
    """``(dx, ddt, da, dB, dC, d_initial_state)`` of ``ssd_scan_ref`` by
    the chunked reverse scan, in f32, in the steps the backward kernel
    takes (``csrc/ssd_backward.cu``).  Per chunk, with ``u = dt x``,
    ``G_qt = C_q.B_t``, ``L_qt = exp(seg_q - seg_t)`` for ``t <= q`` (0
    elsewhere, by selection), ``S_c`` the state entering the chunk and
    ``dS_{c+1}`` the cotangent leaving it:

    - the state pass: ``S_c`` for every chunk, forward;
    - the cotangent pass: ``dS_c = e^{total} dS_{c+1} + sum_q e^{seg_q}
      dy_q C_q^T`` backward from ``d_final`` (zeros when None);
      ``d_initial_state = dS_0``;
    - within each chunk: ``du_t = sum_{q>=t} G_qt L_qt dy_q +
      e^{total-seg_t} dS_{c+1} B_t``; ``dG = L o (dy.u^T)``; ``dC_q =
      sum_t dG_qt B_t + e^{seg_q} S_c^T dy_q``; ``dB_t = sum_q dG_qt C_q
      + e^{total-seg_t} dS_{c+1}^T u_t``; ``dseg`` from ``L`` (``W = G o
      dG``: row sums in, column sums out), from ``e^{seg_q}`` (``C_q .
      dC_state_q``), from ``e^{total-seg_t}`` (``-u_t . du_state_t``),
      and ``dtotal = e^{total} <dS_{c+1}, S_c> + sum_t u_t . du_state_t``
      on the chunk's last position; ``d(a dt)`` is the within-chunk
      reverse cumulative sum of ``dseg``;
    - ``dx = dt du``, ``ddt = x . du + a d(a dt)``, ``da = sum d(a dt)
      dt``; dB and dC summed over the ``H / G`` heads of a group.

    dx, dB and dC come out in their input's dtype, the rest in f32."""
    bsz, seqlen, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    assert seqlen % chunk_size == 0, "pad sequence to a chunk multiple"
    nc, q_len, rep = seqlen // chunk_size, chunk_size, h // g
    dev = x.device

    def to_chunks(t):
        return t.float().reshape((bsz, nc, q_len) + tuple(t.shape[2:]))

    xc, dtc, dyc = to_chunks(x), to_chunks(dt), to_chunks(dy)
    bc = to_chunks(torch.repeat_interleave(b_mat, rep, dim=2))
    cc = to_chunks(torch.repeat_interleave(c_mat, rep, dim=2))
    af = a.float()
    uc = xc * dtc[..., None]                                 # [B,C,Q,H,P]
    seg = torch.cumsum(af * dtc, dim=2)                      # [B,C,Q,H]
    total = seg[:, :, -1]                                    # [B,C,H]
    eseg = torch.exp(seg)
    wdec = torch.exp(total[:, :, None] - seg)                # e^{total-seg}

    # the state pass: S_c entering each chunk
    own = torch.einsum("bcthn,bcthp->bchpn", bc * wdec[..., None], uc)
    s = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=dev)
         if initial_state is None else initial_state.float())
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(total[:, c])[..., None, None] + own[:, c]
    s_in = torch.stack(s_in, 1)                              # [B,C,H,P,N]

    # the cotangent pass: dS_{c+1} leaving each chunk
    ds = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=dev)
          if d_final is None else d_final.float())
    ds_out = [None] * nc
    for c in reversed(range(nc)):
        ds_out[c] = ds
        ds = (ds * torch.exp(total[:, c])[..., None, None]
              + torch.einsum("bqhp,bqhn->bhpn",
                             dyc[:, c] * eseg[:, c, ..., None], cc[:, c]))
    d_init = ds
    ds_out = torch.stack(ds_out, 1)                          # [B,C,H,P,N]

    # within each chunk; [q, t] pairs, masked by selection: exp(seg_q -
    # seg_t) overflows above the diagonal, and inf * 0 is NaN
    causal = torch.tril(torch.ones(q_len, q_len, dtype=torch.bool,
                                   device=dev))[:, :, None]
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]      # [B,C,Q,T,H]
    lmat = torch.where(causal, torch.exp(torch.where(causal, rel, 0.0)),
                       0.0)
    gmat = torch.einsum("bcqhn,bcthn->bcqth", cc, bc)
    dmat = torch.einsum("bcqhp,bcthp->bcqth", dyc, uc)
    dg = lmat * dmat
    w = gmat * dg
    du_state = wdec[..., None] * torch.einsum("bcthn,bchpn->bcthp", bc,
                                              ds_out)
    du = torch.einsum("bcqth,bcqhp->bcthp", gmat * lmat, dyc) + du_state
    dc_state = eseg[..., None] * torch.einsum("bcqhp,bchpn->bcqhn", dyc,
                                              s_in)
    dc_h = torch.einsum("bcqth,bcthn->bcqhn", dg, bc) + dc_state
    db_h = (torch.einsum("bcqth,bcqhn->bcthn", dg, cc)
            + wdec[..., None] * torch.einsum("bcthp,bchpn->bcthn", uc,
                                             ds_out))
    u_du_state = (uc * du_state).sum(-1)                     # [B,C,Q,H]
    dseg = (w.sum(3) - w.sum(2) + (cc * dc_state).sum(-1) - u_du_state)
    dtotal = (torch.exp(total) * (ds_out * s_in).sum((-1, -2))
              + u_du_state.sum(2))
    dseg[:, :, -1] += dtotal
    dld = torch.flip(torch.cumsum(torch.flip(dseg, [2]), 2), [2])

    dx = (du * dtc[..., None]).reshape(bsz, seqlen, h, p)
    ddt = ((xc * du).sum(-1) + dld * af).reshape(bsz, seqlen, h)
    da = (dld * dtc).sum((0, 1, 2))
    db = db_h.reshape(bsz, seqlen, g, rep, n).sum(3)
    dc = dc_h.reshape(bsz, seqlen, g, rep, n).sum(3)
    return (dx.to(x.dtype), ddt, da, db.to(b_mat.dtype), dc.to(c_mat.dtype),
            d_init)


def ssd_decode_step_ref(
    x: torch.Tensor,       # [B, H, P] one token
    dt: torch.Tensor,      # [B, H] f32
    a: torch.Tensor,       # [H] f32
    b_vec: torch.Tensor,   # [B, G, N]
    c_vec: torch.Tensor,   # [B, G, N]
    state: torch.Tensor,   # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence, ``state' = exp(a dt) state + dt x B^T``,
    ``y = state' C``.  Returns ``(y [B, H, P] in x's dtype, state' f32)``.
    The reference computes it in jnp on every backend: it is no kernel."""
    h, g = x.shape[1], b_vec.shape[1]
    rep = h // g
    b_h = torch.repeat_interleave(b_vec, rep, dim=1).float()   # [B, H, N]
    c_h = torch.repeat_interleave(c_vec, rep, dim=1).float()
    decay = torch.exp(a.float()[None] * dt.float())             # [B, H]
    upd = torch.einsum("bhp,bhn->bhpn", x.float() * dt.float()[..., None],
                       b_h)
    new_state = state.float() * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, c_h)
    return y.to(x.dtype), new_state
