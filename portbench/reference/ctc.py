"""The CTC likelihood of a transcript and the CTC prefix beam search, plain.

The likelihood is the forward (alpha) recursion of Graves et al. 2006 over
the blank-interleaved transcript, in float64 log space, one utterance at a
time in a batch.

The search is the prefix beam search (Hannun et al. 2014) that the port's
``CTCPrefixSearch`` runs without a language model: each of ``width`` beams
keeps a non-blank and a blank mass; at each frame every beam extends by
every token (its own last token only from its blank mass), keeps itself
(its non-blank mass times its last token's probability plus every mass
times the blank's), an extension that equals another beam is folded into
that beam, and the ``width`` largest masses survive. It takes every
candidate, where the port takes each beam's top ``2 * width`` tokens and
its last one, which holds the same ``width`` largest. Masses are kept in
``dtype`` (float64 by default) and rescaled each frame by the row's best
mass; the scales are kept as a log. Beams come out best first.
"""

import math

import torch

NEG = -1e30


@torch.no_grad()
def log_likelihood(logits, out_lens, refs, ref_lens, blank):
    """``log p(ref | logits)`` of each utterance, ``(N,)`` float64;
    ``logits (N, T, V + 1)`` batch-major, ``refs (N, U)``; -inf (to the
    floor) where no alignment fits in the utterance's frames."""
    lp = torch.log_softmax(logits.double(), -1)  # (N, T, V + 1)
    N, T, _ = lp.shape
    U = refs.shape[1]
    S = 2 * U + 1
    dev = lp.device
    ext = torch.full((N, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = refs.long()
    ref_lens = ref_lens.to(dev).long()
    out_lens = out_lens.to(dev).long()
    s_idx = torch.arange(S, device=dev)
    valid_s = s_idx[None] < (2 * ref_lens + 1)[:, None]
    # a skip from s - 2 is allowed onto a label that differs from s - 2's
    skip = torch.zeros((N, S), dtype=torch.bool, device=dev)
    skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    # a large finite floor, not -inf: logsumexp's gradient at all -inf is NaN
    neg = torch.tensor(NEG, dtype=lp.dtype, device=dev)
    emit = torch.gather(lp, 2, ext[:, None, :].expand(N, T, S))  # (N, T, S)
    alpha = torch.full((N, S), NEG, dtype=lp.dtype, device=dev)
    alpha[:, 0] = emit[:, 0, 0]
    alpha[:, 1] = torch.where(ref_lens > 0, emit[:, 0, 1], neg)
    alpha = torch.where(valid_s, alpha, neg)
    for t in range(1, T):
        a1 = torch.cat([alpha.new_full((N, 1), NEG), alpha[:, :-1]], 1)
        a2 = torch.cat([alpha.new_full((N, 2), NEG), alpha[:, :-2]], 1)
        a2 = torch.where(skip, a2, neg)
        new = torch.logsumexp(torch.stack([alpha, a1, a2]), 0) + emit[:, t]
        new = torch.where(valid_s, new, neg)
        alpha = torch.where((t < out_lens)[:, None], new, alpha)
    end = 2 * ref_lens
    last = torch.gather(alpha, 1, end[:, None])[:, 0]
    prev = torch.gather(alpha, 1, (end - 1).clamp_min(0)[:, None])[:, 0]
    prev = torch.where(ref_lens > 0, prev, neg)
    return torch.logaddexp(last, prev)


def _topk_stable(x, k):
    """Top-``k`` values and indices, ties to the lower index."""
    order = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, order), order


@torch.no_grad()
def prefix_search(logits, lens, width, dtype=torch.float64):
    """Prefix search of time-major ``logits (T, N, V + 1)`` (blank last).
    Returns ``(tokens, log_mass)``: ``tokens[n][w]`` the tuple of beam
    ``w``'s tokens and ``log_mass (N, W)`` float64 natural logs of their
    masses (-inf for beams that do not exist)."""
    T, N, V1 = logits.shape
    V, W = V1 - 1, width
    dev = logits.device
    lens = lens.to(dev).long()
    probs = torch.softmax(logits.double(), -1).to(dtype)
    neg = torch.tensor(-1.0, dtype=dtype, device=dev)
    # beams: masses (N, W) with -1 marking a beam that does not exist
    nb = torch.full((N, W), -1.0, dtype=dtype, device=dev)
    b = torch.full((N, W), -1.0, dtype=dtype, device=dev)
    nb[:, 0], b[:, 0] = 0.0, 1.0
    buf = torch.zeros((N, W, max(T, 1)), dtype=torch.long, device=dev)
    blen = torch.zeros((N, W), dtype=torch.long, device=dev)
    log_scale = torch.zeros((N,), dtype=torch.float64, device=dev)
    pos = torch.arange(buf.shape[2], device=dev)
    for t in range(T):
        p = probs[t]
        pb, pv = p[:, V], p[:, :V]  # (N,), (N, V)
        alive = nb >= 0
        last = torch.gather(buf, 2, (blen - 1).clamp_min(0)[..., None])[..., 0]  # (N, W)
        has_last = blen > 0
        nbz, bz = nb.clamp_min(0), b.clamp_min(0)
        is_last = (torch.arange(V, device=dev)[None, None] == last[..., None]) & has_last[..., None]
        ext = torch.where(is_last, bz[..., None], (nbz + bz)[..., None]) * pv[:, None, :]
        ext = torch.where(alive[..., None], ext, neg)  # (N, W, V)
        keep_nb = torch.where(has_last, nbz * torch.gather(pv, 1, last), 0.0)
        keep_b = (nbz + bz) * pb[:, None]
        # fold extensions that equal an existing beam j into j: k is j's
        # prefix and j is one token longer
        same = (buf[:, :, None, :] == buf[:, None, :, :]) | (
            pos[None, None, None] >= blen[:, :, None, None]
        )
        is_prefix = same.all(-1) & (blen[:, :, None] + 1 == blen[:, None, :])  # (N, k, j)
        is_prefix &= alive[:, :, None] & alive[:, None, :]
        tok_j = last[:, None, :].expand(N, W, W)
        folded = torch.where(is_prefix, torch.gather(ext, 2, tok_j), 0.0).sum(1)  # (N, j)
        keep_nb = keep_nb + folded
        hit = torch.zeros((N, W, V + 1), dtype=torch.bool, device=dev)
        hit.scatter_(2, torch.where(is_prefix, tok_j, V), True)
        ext = torch.where(hit[..., :V], neg, ext)
        keep = torch.where(alive, keep_nb + keep_b, neg)
        cand = torch.cat([keep, ext.reshape(N, W * V)], 1)
        top, idx = _topk_stable(cand, W)
        is_keep = idx < W
        src = torch.where(is_keep, idx, (idx - W) // V)
        tok = (idx - W) % V
        new_nb = torch.where(is_keep, torch.gather(keep_nb, 1, src), top)
        new_b = torch.where(is_keep, torch.gather(keep_b, 1, src), 0.0)
        new_buf = torch.gather(buf, 1, src[..., None].expand(N, W, buf.shape[2]))
        src_len = torch.gather(blen, 1, src)
        write = (~is_keep)[..., None] & (pos[None, None] == src_len[..., None])
        new_buf = torch.where(write, tok[..., None], new_buf)
        new_len = src_len + (~is_keep).long()
        dead = top < 0
        new_nb = torch.where(dead, neg, new_nb)
        new_b = torch.where(dead, neg, new_b)
        best = (new_nb[:, 0] + new_b[:, 0]).clamp_min(torch.finfo(dtype).tiny)
        new_nb = torch.where(dead, neg, new_nb / best[:, None])
        new_b = torch.where(dead, neg, new_b / best[:, None])
        run = (t < lens)[:, None]
        nb = torch.where(run, new_nb, nb)
        b = torch.where(run, new_b, b)
        buf = torch.where(run[..., None], new_buf, buf)
        blen = torch.where(run, new_len, blen)
        log_scale = torch.where(run[:, 0], log_scale + torch.log(best.double()), log_scale)
    mass = nb.double() + b.double()
    log_mass = torch.where(nb >= 0, torch.log(mass.clamp_min(1e-300)) + log_scale[:, None],
                           torch.tensor(-math.inf, dtype=torch.float64, device=dev))
    buf_c, blen_c = buf.cpu(), blen.cpu()
    tokens = [
        [tuple(buf_c[n, w, : blen_c[n, w]].tolist()) for w in range(W)] for n in range(N)
    ]
    return tokens, log_mass.cpu()
