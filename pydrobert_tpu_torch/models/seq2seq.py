"""Attention seq2seq ASR model and its minimum-error-rate training step
(counterpart of :mod:`pydrobert_tpu.models.seq2seq`).

A GRU encoder over features and a Bahdanau-attention GRU decoder exposed
as a sequential LM (:class:`Seq2SeqDecoderLM`), so that
:class:`~pydrobert_tpu_torch.ops.decoding.BeamSearch` decodes it and
:class:`~pydrobert_tpu_torch.ops.decoding.RandomWalk` samples it for
:func:`make_mer_train_step`.

The GRU cells are flax's ``nn.GRUCell``: input denses ``ir``, ``iz``,
``in`` with biases and recurrent denses ``hr``, ``hz`` without, ``hn``
with one, named as the flax tree names them, so :func:`state_dict_from_jax`
is a renaming and a transpose. PyTorch's fused GRU has two more biases
(``b_hr``, ``b_hz``); the encoder builds the fused op's flat weights from
the six denses on each call with those two held at zero, so no parameter
exists that the JAX model lacks, and the sequence runs in one fused call
(cuDNN on the card, in TF32 unless ``torch.backends.cudnn.allow_tf32`` is
False). As flax's ``nn.RNN(seq_lengths=...)`` does, the encoder runs the
cell through the padding: its outputs at padded frames are the cell run on
padding, and the mask hides them from the attention.
"""

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import default_device
from ..lm import ExtractableSequentialLanguageModel
from ..ops.attn import ConcatSoftAttention, _dense

__all__ = [
    "AttentionSeq2Seq",
    "Seq2SeqConfig",
    "Seq2SeqDecoderLM",
    "adam",
    "make_mer_train_step",
    "state_dict_from_jax",
]


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    """Hyperparameters of :class:`AttentionSeq2Seq`, the JAX package's
    ``Seq2SeqConfig``."""

    vocab_size: int = 32  # excludes sos handling; eos must be < vocab
    num_filts: int = 40
    enc_hidden: int = 128
    dec_hidden: int = 128
    embed_dim: int = 64
    attn_hidden: int = 128


class _GRUCell(nn.Module):
    """flax's ``nn.GRUCell`` parameters: six denses, named as flax names
    them (``in`` is set by name, being a Python keyword)."""

    def __init__(self, d_in: int, hidden: int, generator):
        super().__init__()
        self.hidden = hidden
        for g in ("ir", "iz", "in"):
            self.add_module(g, _dense(d_in, hidden, True, generator))
        for g in ("hr", "hz", "hn"):
            lin = nn.Linear(hidden, hidden, bias=g == "hn")
            with torch.no_grad():
                nn.init.orthogonal_(lin.weight, generator=generator)
                if g == "hn":
                    lin.bias.zero_()
            self.add_module(g, lin)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One step, flax's arithmetic: ``(new_h, new_h)``'s ``new_h``."""
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h

    def sequence(self, x: torch.Tensor) -> torch.Tensor:
        """The cell over ``x (N, T, d_in)`` from a zero carry, every step's
        output ``(N, T, hidden)``, in one fused GRU call. Its flat weights
        stack the gates r, z, n; the recurrent biases of r and z are zero
        constants."""
        H = self.hidden
        w_ih = torch.cat([self.ir.weight, self.iz.weight, getattr(self, "in").weight])
        w_hh = torch.cat([self.hr.weight, self.hz.weight, self.hn.weight])
        b_ih = torch.cat([self.ir.bias, self.iz.bias, getattr(self, "in").bias])
        b_hh = torch.cat([self.hn.bias.new_zeros(2 * H), self.hn.bias])
        h0 = x.new_zeros((1, x.shape[0], H))
        out, _ = torch._VF.gru(
            x, h0, [w_ih, w_hh, b_ih, b_hh], True, 1, 0.0,
            torch.is_grad_enabled(), False, True,
        )
        return out


class _Encoder(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, generator):
        super().__init__()
        self.proj = _dense(cfg.num_filts, cfg.enc_hidden, True, generator)
        self.rnn = _GRUCell(cfg.enc_hidden, cfg.enc_hidden, generator)

    def forward(self, feats, lens):
        x = self.rnn.sequence(torch.tanh(self.proj(feats)))
        mask = torch.arange(x.shape[1], device=x.device)[None] < lens[:, None]
        return x, mask  # (N, T, H), (N, T)


class _DecoderStep(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, generator):
        super().__init__()
        self.embed = nn.Embedding(cfg.vocab_size + 1, cfg.embed_dim)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0, generator=generator)
        self.attn = ConcatSoftAttention(
            query_size=cfg.dec_hidden, key_size=cfg.enc_hidden, dim=1,
            hidden_size=cfg.attn_hidden, generator=generator,
        )
        self.cell = _GRUCell(cfg.embed_dim + cfg.enc_hidden, cfg.dec_hidden, generator)
        self.out = _dense(cfg.dec_hidden, cfg.vocab_size, True, generator)

    def forward(self, tok, hidden, enc, enc_mask):
        """One decoder step: embed, attend, GRU, logits. ``tok (N,)`` in
        ``[0, vocab]`` (``vocab`` is the sos slot), ``hidden (N, H)``,
        ``enc (N, T, C)``, ``enc_mask (N, T)``."""
        emb = self.embed(tok.long())
        ctx = self.attn(hidden, enc, enc, enc_mask)  # (N, C)
        new_hidden = self.cell(hidden, torch.cat([emb, ctx], -1))
        return self.out(new_hidden), new_hidden


class AttentionSeq2Seq(nn.Module):
    """The encoder and the step decoder. ``AttentionSeq2Seq(cfg,
    device=None, generator=None)`` builds it on ``device`` (``cuda`` when
    None; raises without a card) with weights drawn from ``generator`` (a
    CPU :class:`torch.Generator`, so a seed gives the same weights on every
    device) at flax's initializers' scales."""

    def __init__(
        self,
        cfg: Seq2SeqConfig,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = default_device(device)
        self.cfg = cfg
        self.encoder = _Encoder(cfg, generator)
        self.decoder_step = _DecoderStep(cfg, generator)
        self.to(device)

    def encode(self, feats, lens):
        """``(enc (N, T, enc_hidden), mask (N, T))`` from batch-major
        ``feats (N, T, num_filts)`` and ``lens (N,)``."""
        dev = self.encoder.proj.weight.device
        return self.encoder(feats.to(dev), lens.to(dev))

    def step(self, tok, hidden, enc, enc_mask):
        """``(logits (N, vocab_size), new_hidden (N, dec_hidden))``."""
        return self.decoder_step(tok, hidden, enc, enc_mask)


class Seq2SeqDecoderLM(ExtractableSequentialLanguageModel):
    """The decoder as a sequential LM for ``BeamSearch`` and
    ``RandomWalk``. State: ``{"hidden": (N, H), "enc": (N, T, C),
    "enc_mask": (N, T)}``, all batch-major, so the default beam reordering
    applies; build it with :meth:`initial_state`. The first step embeds
    the dedicated sos slot ``vocab_size``."""

    def __init__(self, model: AttentionSeq2Seq):
        super().__init__(model.cfg.vocab_size)
        self.model = model
        self.sos_slot = model.cfg.vocab_size

    def initial_state(self, feats, lens) -> Dict[str, Any]:
        enc, mask = self.model.encode(feats, lens)
        hidden = enc.new_zeros((feats.shape[0], self.model.cfg.dec_hidden))
        return {"hidden": hidden, "enc": enc, "enc_mask": mask}

    def update_input(self, prev, hist):
        if not all(k in prev for k in ("hidden", "enc", "enc_mask")):
            raise RuntimeError(
                "initial state must be built with initial_state(feats, lens)"
            )
        return prev

    def calc_idx_log_probs(self, hist, prev, idx):
        hist = torch.as_tensor(hist)
        S, N = hist.shape
        dev = prev["hidden"].device
        idxs = torch.as_tensor(idx, dtype=torch.long, device=dev).expand(N)
        if S:
            prev_tok = hist.to(dev)[(idxs - 1).clamp(0, S - 1), torch.arange(N, device=dev)]
        else:
            prev_tok = torch.zeros((N,), dtype=torch.long, device=dev)
        prev_tok = torch.where(idxs == 0, self.sos_slot, prev_tok.long())
        prev_tok = prev_tok.clamp(0, self.sos_slot)
        logits, hidden = self.model.step(
            prev_tok, prev["hidden"], prev["enc"], prev["enc_mask"]
        )
        return torch.log_softmax(logits, -1), {**prev, "hidden": hidden}


def _linear(kernel, bias=None) -> Dict[str, np.ndarray]:
    out = {"weight": np.asarray(kernel).T}
    if bias is not None:
        out["bias"] = np.asarray(bias)
    return out


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """An :class:`AttentionSeq2Seq` ``state_dict`` from the JAX package's
    flax parameters (the ``{"params": ...}`` dict ``init`` returns, or its
    ``"params"`` entry), as nested dicts of numpy arrays. Dense kernels
    ``(in, out)`` transpose to ``(out, in)``; the encoder's cell, flax's
    ``GRUCell_0``, becomes ``encoder.rnn``. Linear, so it also carries a
    gradient tree onto the port's ``.grad`` names."""
    params = params.get("params", params)
    out: Dict[str, np.ndarray] = {}

    def put(prefix, d):
        for k, v in d.items():
            out[f"{prefix}.{k}"] = v

    def cell(prefix, p):
        for g in ("ir", "iz", "in", "hr", "hz", "hn"):
            put(f"{prefix}.{g}", _linear(p[g]["kernel"], p[g].get("bias")))

    enc, dec = params["encoder"], params["decoder_step"]
    put("encoder.proj", _linear(enc["proj"]["kernel"], enc["proj"]["bias"]))
    cell("encoder.rnn", enc["GRUCell_0"])
    out["decoder_step.embed.weight"] = np.asarray(dec["embed"]["embedding"])
    attn = dec["attn"]
    put("decoder_step.attn.linear", _linear(attn["linear"]["kernel"], attn["linear"].get("bias")))
    out["decoder_step.attn.v"] = np.asarray(attn["v"])
    cell("decoder_step.cell", dec["cell"])
    put("decoder_step.out", _linear(dec["out"]["kernel"], dec["out"]["bias"]))
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in out.items()}


def adam(
    params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
) -> torch.optim.Adam:
    """``torch.optim.Adam`` with ``optax.adam``'s defaults (no decay)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps)


def make_mer_train_step(
    model: AttentionSeq2Seq,
    optimizer: torch.optim.Optimizer,
    num_samples: int = 4,
    max_iters: int = 32,
    eos: Optional[int] = None,
) -> Callable:
    """The minimum-error-rate training step: ``step(generator, feats,
    feat_lens, refs, ref_lens) -> loss``.

    It draws ``num_samples`` hypotheses per utterance with
    :class:`~pydrobert_tpu_torch.ops.decoding.RandomWalk` (from
    ``generator``, on the model's device), scores them with the model's
    log-probabilities (eos included) and weighs their error rates against
    ``refs (N, R)`` (the terminal eos not counted) by the softmax of those
    scores; then the backward and one optimizer step. As
    :func:`~pydrobert_tpu_torch.models.conformer.make_train_step`, it
    updates ``model`` and ``optimizer`` in place and returns the detached
    loss. The sampler is looked up in :mod:`pydrobert_tpu_torch.ops.
    decoding` at each call."""
    from ..ops import decoding
    from ..ops.string import minimum_error_rate_loss

    def step(generator, feats, feat_lens, refs, ref_lens):
        dev = model.encoder.proj.weight.device
        feats, feat_lens = feats.to(dev), feat_lens.to(dev)
        refs, ref_lens = refs.to(dev), ref_lens.to(dev)
        lm = Seq2SeqDecoderLM(model)
        state = lm.initial_state(feats, feat_lens)
        N, M = feats.shape[0], num_samples
        tiled = {k: v.repeat_interleave(M, 0) for k, v in state.items()}
        with torch.no_grad():
            walk = decoding.RandomWalk(lm, eos=eos)
            y, y_lens, _ = walk(generator, dict(tiled), N * M, max_iters)  # (S, N*M)
        S = y.shape[0]
        pos = torch.arange(S, device=dev)[:, None]
        y_m = torch.where(pos < y_lens[None], y, -1)  # with eos: scored
        if eos is not None:
            # the error rate does not count the terminal eos
            last = torch.gather(y, 0, (y_lens - 1).clamp_min(0)[None].long())[0]
            rate_lens = y_lens - ((last == eos) & (y_lens > 0)).to(y_lens.dtype)
        else:
            rate_lens = y_lens
        y_rate = torch.where(pos < rate_lens[None], y, -1)
        lp_full = lm(y, prev=dict(tiled))  # (S + 1, N * M, V)
        log_probs = decoding.sequence_log_probs(
            lp_full[:-1].transpose(0, 1), y_m.T, dim=-1
        ).reshape(N, M)
        R = refs.shape[1]
        refs_t = torch.where(
            torch.arange(R, device=dev)[:, None] < ref_lens[None], refs.T, -1
        )  # (R, N), time-major, padding -1
        loss = minimum_error_rate_loss(
            log_probs, refs_t, y_rate.reshape(S, N, M), eos=-1,
            include_eos=False, warn=False,
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
