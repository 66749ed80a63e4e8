"""The transducer's prediction network and joint (Graves 2012; Conformer-M's
one-layer LSTM decoder), plain, and the judge of a greedy transcript.

The prediction network embeds the previous token (the blank starts every
transcript) into an LSTM cell (gates i, f, g, o; input kernels without
bias, hidden kernels with one; a zero first state). The joint maps
``tanh(enc_proj(enc_t) + pred_proj(pred_u))`` to the ``V + 1`` logits, the
blank last. All in float32, as the port runs them.

:func:`judge` judges served greedy transcripts. The joint's logits at
frame ``t`` after ``u`` served tokens depend on the encoder's frame and the
prediction network's output after those ``u`` tokens alone, so the
reference scores every ``(t, u)`` once. A greedy decode of the transcript
is an alignment: at each step it emits the next served token (while fewer
than ``max_symbols`` were emitted on the frame) or takes the blank and
moves on, and a step after ``max_symbols`` emissions moves on unjudged.
A step's gap is how far the reference's best logit lies above the logit of
what the step took. The judge reads the smallest widest gap of any such
alignment (a minimax over the ``(t, u, emitted on the frame)`` lattice):
a transcript that the reference's greedy decode would give reads 0, a
near-tie decided the other way reads the tie's margin, and a wrong token
reads at least the gap of that token where it fits best. A transcript no
alignment can place reads infinity.
"""

import numpy as np
import torch

from .precision import Exact, linear


def lstm_step(W, x, carry, prec=Exact):
    c, h = carry
    p = "predictor.lstm."
    gates = []
    for g in "ifgo":
        gates.append(
            linear(prec, x, W[f"{p}i{g}.weight"]) + linear(prec, h, W[f"{p}h{g}.weight"],
                                                          W[f"{p}h{g}.bias"])
        )
    i, f, g, o = gates
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (c, h)


def predict(W, tok, carry, prec=Exact):
    return lstm_step(W, W["predictor.embed.weight"][tok], carry, prec)


def joint(W, enc_t, pred_u, prec=Exact):
    z = torch.tanh(
        linear(prec, enc_t, W["joint.enc_proj.weight"], W["joint.enc_proj.bias"])
        + linear(prec, pred_u, W["joint.pred_proj.weight"], W["joint.pred_proj.bias"])
    )
    return linear(prec, z, W["joint.out.weight"], W["joint.out.bias"])


def _pred_outputs(W, hyps, U, prec=Exact):
    """Prediction-network outputs after 0..U served tokens: ``(N, U + 1, P)``."""
    N = hyps.shape[0]
    V1, P = W["predictor.embed.weight"].shape
    zero = torch.zeros((N, P), device=hyps.device)
    tok = torch.full((N,), V1 - 1, dtype=torch.long, device=hyps.device)
    out, carry = [], (zero, zero)
    for u in range(U + 1):
        pred, carry = predict(W, tok, carry, prec)
        out.append(pred)
        if u < U:
            tok = hyps[:, u].clamp(0, V1 - 2)
    return torch.stack(out, 1)


def _grid(W, enc_t, pred_u, prec=Exact):
    """The joint's logits at every ``(t, u)``: ``(T, U + 1, V + 1)``."""
    e = linear(prec, enc_t, W["joint.enc_proj.weight"], W["joint.enc_proj.bias"])
    p = linear(prec, pred_u, W["joint.pred_proj.weight"], W["joint.pred_proj.bias"])
    z = torch.tanh(e[:, None, :] + p[None, :, :])
    return linear(prec, z, W["joint.out.weight"], W["joint.out.bias"])


@torch.no_grad()
def judge(W, enc, enc_lens, hyps, hyp_lens, max_symbols, other=None):
    """Judge served greedy transcripts ``hyps (N, U)`` with ``hyp_lens`` over
    the reference's encoder output ``enc (N, T, d)``: ``(gap (N,) float64
    numpy)``, each row's smallest widest gap over its alignments. With
    ``other = (enc2, W2, prec2)`` a row reads instead, along its best
    alignment, the gap of the token that ``other`` puts first at each
    judged step (the control: a lower precision in the program's place)."""
    E = int(max_symbols)
    dev = enc.device
    N = enc.shape[0]
    blank = W["joint.out.weight"].shape[0] - 1
    T_n = enc_lens.long().cpu().numpy()
    U_n = hyp_lens.long().cpu().numpy()
    Tm, Um = int(T_n.max(initial=0)), int(U_n.max(initial=0))
    hyps = hyps.to(dev).long()
    if hyps.shape[1] < Um + 1:
        hyps = torch.cat([hyps, hyps.new_full((N, Um + 1 - hyps.shape[1]), blank)], 1)
    pred = _pred_outputs(W, hyps, Um)
    if other is not None:
        enc2, W2, prec2 = other
        pred2 = _pred_outputs(W2, hyps, Um, prec2)
    gb = np.full((N, Tm, Um + 1), np.inf)
    ge = np.full((N, Tm, Um + 1), np.inf)
    first = np.zeros((N, Tm, Um + 1)) if other is not None else None
    for n in range(N):
        T, U = int(T_n[n]), int(U_n[n])
        if T == 0:
            continue
        lg = _grid(W, enc[n, :T], pred[n, : U + 1])
        best = lg.max(-1).values
        gb[n, :T, : U + 1] = (best - lg[..., blank]).double().cpu().numpy()
        if U:
            y = hyps[n, :U]
            emit = torch.gather(lg[:, :U], 2, y[None, :, None].expand(T, U, 1))[..., 0]
            ge[n, :T, :U] = (best[:, :U] - emit).double().cpu().numpy()
        if other is not None:
            pick = _grid(W2, enc2[n, :T], pred2[n, : U + 1], prec2).argmax(-1)
            got = torch.gather(lg, 2, pick[..., None])[..., 0]
            first[n, :T, : U + 1] = (best - got).double().cpu().numpy()
    rows = np.arange(N)
    # value of (t, u, k) with t = T: 0 once every served token is placed
    term = np.full((N, Um + 2, E + 1), np.inf)
    term[rows, U_n, :] = 0.0
    nxt = term.copy()
    emit_choice = np.zeros((N, Tm, Um + 1, E), dtype=bool)
    for t in reversed(range(Tm)):
        cur = np.full((N, Um + 2, E + 1), np.inf)
        for u in reversed(range(Um + 1)):
            take_blank = np.maximum(gb[:, t, u], nxt[:, u, 0])[:, None]
            take_emit = np.maximum(ge[:, t, u][:, None], cur[:, u + 1, 1:])
            emit_choice[:, t, u] = take_emit < take_blank
            cur[:, u, :E] = np.minimum(take_blank, take_emit)
            cur[:, u, E] = nxt[:, u, 0]
        done = t >= T_n
        cur[done] = term[done]
        nxt = cur
    gap = nxt[:, 0, 0].copy()
    if other is None:
        return gap
    ctrl = np.zeros(N)
    for n in range(N):
        t = u = k = 0
        while t < T_n[n] and np.isfinite(gap[n]):
            if k == E:
                t, k = t + 1, 0
                continue
            ctrl[n] = max(ctrl[n], first[n, t, u])
            if emit_choice[n, t, u, k]:
                u, k = u + 1, k + 1
            else:
                t, k = t + 1, 0
    return np.where(np.isfinite(gap), ctrl, np.inf)
