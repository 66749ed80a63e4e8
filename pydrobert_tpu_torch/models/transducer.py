"""Conformer-Transducer (RNN-T) acoustic model, its streaming searches and
its training step (counterpart of :mod:`pydrobert_tpu.models.transducer`).

The encoder is :class:`~pydrobert_tpu_torch.models.ConformerCTC`'s, without
the CTC head, under ``encoder.``; the prediction network embeds the label
history (the blank, index ``vocab_size``, is the start token) into flax's
``OptimizedLSTMCell``; the joint adds projections of an encoder frame and a
predictor output and maps their ``tanh`` to ``vocab_size + 1`` logits.
Parameter names follow the flax tree, so :func:`state_dict_from_jax` is a
renaming and a transpose.

flax's LSTM cell has input kernels ``ii``, ``if``, ``ig``, ``io`` without
bias and hidden kernels ``hi``, ``hf``, ``hg``, ``ho`` with one, gates in
PyTorch's order (i, f, g, o), and a zero carry ``(c, h)`` at the start.
The predictor stacks those eight denses into PyTorch's LSTM weights (the
input bias a zero constant, so no parameter exists that the JAX model
lacks). The training pass runs the fused sequence op over the whole
history (cuDNN on the card, in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False); a decode step runs the same
cell on one token with ``torch.lstm_cell`` (one fused pointwise kernel on
the card), on weights stacked once per search.

The training forward never holds the ``(N, T, U + 1, V + 1)`` joint: it
evaluates slabs of a few frames, reduces each at once to the blank ``(N,
U + 1)`` and emit ``(N, U)`` log-probabilities of its frames, and
recomputes the slab in the backward pass (:func:`torch.utils.checkpoint`).
"""

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import default_device
from ..ops.transducer import (
    transducer_beam_advance,
    transducer_beam_finalize,
    transducer_beam_init,
    transducer_beam_search,
    transducer_greedy_advance,
    transducer_greedy_init,
    transducer_greedy_search,
    transducer_loss,
)
from .conformer import (
    ConformerConfig,
    _add_encoder,
    _encoder_body,
    _encoder_state_dict,
    _init_params,
    _linear,
    margin_chunks,
    moe_aux_loss,
)

__all__ = [
    "ConformerTransducer",
    "TransducerConfig",
    "lookup_lm_fusion",
    "make_transducer_pipeline_train_step",
    "make_transducer_train_step",
    "state_dict_from_jax",
    "streaming_transducer_beam",
    "streaming_transducer_greedy",
    "transducer_partition_rules",
    "transducer_pipeline_partition_rules",
    "transducer_stack_block_params",
    "transducer_unstack_block_params",
]

# the most joint entries one slab of the streamed training joint may hold
SLAB_ELEMENTS = 1 << 22


def lookup_lm_fusion(lm, batch_size: int, vocab_pad: int = 1):
    """Shallow-fusion hooks for :func:`~pydrobert_tpu_torch.ops.transducer.
    transducer_beam_search` from a :class:`~pydrobert_tpu_torch.lm.
    LookupLanguageModel`: ``(lm_step, init_lp, init_state)``.

    The state is a rolling ``(B, K)`` context window, earliest first, ``K =
    max(max_ngram - 1, 1)``, filled with the LM's ``sos`` at the start; an
    emitted token shifts it and one ``calc_idx_log_probs`` row scores the
    next position. Rows are log-softmaxed and right-padded with
    ``vocab_pad`` zero columns, so they line up with a joint whose blank
    sits past the LM's vocabulary (the pad is never read). Everything
    lives on the LM's device."""
    K = max(lm.max_ngram - 1, 1)

    def row(ctx):
        lp, _ = lm.calc_idx_log_probs(ctx.T, {}, K)
        return F.pad(torch.log_softmax(lp, -1), (0, vocab_pad))

    def lm_step(tok, ctx):
        new_ctx = torch.cat([ctx[:, 1:], tok.to(ctx)[:, None]], 1)
        return row(new_ctx), new_ctx

    ctx0 = torch.full((batch_size, K), lm.sos, dtype=torch.long, device=lm.device)
    return lm_step, row(ctx0), ctx0


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    """Hyperparameters for :class:`ConformerTransducer` (the JAX package's
    ``TransducerConfig``)."""

    encoder: ConformerConfig = ConformerConfig()
    pred_dim: int = 256
    joint_dim: int = 256

    @property
    def vocab_size(self) -> int:
        return self.encoder.vocab_size  # blank = vocab_size (last index)


class _Encoder(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        _add_encoder(self, cfg)

    def forward(self, feats, lens, deterministic=True, generator=None, pos_offset=0, return_aux=False):
        x, _, out_lens, aux = _encoder_body(
            self, self.cfg, feats, lens, deterministic, generator, pos_offset
        )
        return (x.float(), out_lens, aux) if return_aux else (x.float(), out_lens)


_GATES = ("i", "f", "g", "o")


class _LSTM(nn.Module):
    """flax's ``OptimizedLSTMCell`` parameters under their flax names
    (``if`` is set by name, being a Python keyword)."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in _GATES:
            self.add_module(f"i{g}", nn.Linear(d_in, hidden, bias=False))
            self.add_module(f"h{g}", nn.Linear(hidden, hidden))

    def weights(self):
        """PyTorch's LSTM weights: ``(w_ih, w_hh, b_hh)``, the gates
        stacked in the order (i, f, g, o)."""
        lin = [getattr(self, f"{p}{g}") for p in "ih" for g in _GATES]
        return (
            torch.cat([m.weight for m in lin[:4]]),
            torch.cat([m.weight for m in lin[4:]]),
            torch.cat([m.bias for m in lin[4:]]),
        )

    def forward(self, x: torch.Tensor, carry: Tuple[torch.Tensor, torch.Tensor]):
        """The cell over ``x (N, S, d_in)`` from ``carry = (c, h)`` (each
        ``(N, hidden)``), in one fused call: every step's output ``(N, S,
        hidden)`` and the last carry."""
        w_ih, w_hh, b_hh = self.weights()
        c, h = carry
        out, h_n, c_n = torch._VF.lstm(
            x, (h[None], c[None]), [w_ih, w_hh, torch.zeros_like(b_hh), b_hh], True, 1,
            0.0, torch.is_grad_enabled(), False, True,
        )
        return out, (c_n[0], h_n[0])

    @staticmethod
    def step(x: torch.Tensor, carry, weights):
        """The cell on one input ``x (N, d_in)`` with :meth:`weights`:
        ``(h, (c, h))``."""
        c, h = carry
        b_ih = None
        if torch.compiler.is_exporting():
            # the traced fused cell's shape function reads the input bias's
            # device (PyTorch 2.11): trace a zero one (a + 0.0 in the gates)
            b_ih = torch.zeros_like(weights[2])
        h, c = torch.lstm_cell(x, (h, c), weights[0], weights[1], b_ih, weights[2])
        return h, (c, h)


class _Predictor(nn.Module):
    """The embedding over ``vocab_size + 1`` tokens and the LSTM."""

    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        self.vocab_size = cfg.vocab_size
        self.pred_dim = cfg.pred_dim
        self.embed = nn.Embedding(cfg.vocab_size + 1, cfg.pred_dim)
        self.lstm = _LSTM(cfg.pred_dim, cfg.pred_dim)

    def init_carry(self, N: int):
        z = self.embed.weight.new_zeros((N, self.pred_dim))
        return z, z.clone()

    def forward(self, toks: torch.Tensor) -> torch.Tensor:
        """The training pass: ``toks (N, U)`` to the outputs after each
        prefix ``(N, U + 1, P)`` (position 0: the blank alone)."""
        N = toks.shape[0]
        start = toks.new_full((N, 1), self.vocab_size)
        x = self.embed(torch.cat([start, toks], 1).long())
        out, _ = self.lstm(x, self.init_carry(N))
        return out

    def stepper(self) -> Callable:
        """``step(tok (N,), carry) -> (out (N, P), carry)``, one decode step
        on emitted tokens, its LSTM weights stacked once."""
        weights = self.lstm.weights()
        return lambda tok, carry: self.lstm.step(self.embed(tok.long()), carry, weights)


class _Joint(nn.Module):
    def __init__(self, cfg: TransducerConfig):
        super().__init__()
        d = cfg.encoder.d_model
        self.enc_proj = nn.Linear(d, cfg.joint_dim)
        self.pred_proj = nn.Linear(cfg.pred_dim, cfg.joint_dim)
        self.out = nn.Linear(cfg.joint_dim, cfg.vocab_size + 1)

    def forward(self, enc_t: torch.Tensor, pred_u: torch.Tensor) -> torch.Tensor:
        """``enc_t (..., D)`` and ``pred_u (..., P)``, broadcast-compatible
        in their leading axes, to logits ``(..., V + 1)``."""
        return self.out(torch.tanh(self.enc_proj(enc_t) + self.pred_proj(pred_u)))


class ConformerTransducer(nn.Module):
    """Conformer encoder, LSTM predictor and additive joint.

    ``ConformerTransducer(cfg, device=None, generator=None)`` builds the
    model on ``device`` (``cuda`` when None; raises without a card) with
    weights drawn from ``generator`` (a CPU :class:`torch.Generator`, so a
    seed gives the same weights on every device; see :meth:`_init_decoder`
    for the decoder's scales). Called with ``feats (N, T, num_filts)``, ``lens``, ``refs (N,
    U)`` and ``ref_lens`` it returns the mean transducer loss (dropout on
    with ``deterministic=False``, its bits from ``generator``);
    :meth:`encode`, :meth:`greedy` and :meth:`beam` decode. The blank is
    index ``vocab_size``."""

    def __init__(
        self,
        cfg: TransducerConfig,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = default_device(device)
        self.cfg = cfg
        self.encoder = _Encoder(cfg.encoder)
        self.predictor = _Predictor(cfg)
        self.joint = _Joint(cfg)
        _init_params(self.encoder, generator)
        self._init_decoder(generator)
        self.to(device)

    @torch.no_grad()
    def _init_decoder(self, generator):
        """LeCun-normal input kernels and denses, orthogonal recurrent
        kernels and zero biases (flax's defaults' scales), the embedding
        normal with variance ``1 / (V + 1)``; the draws differ from
        flax's."""
        emb = self.predictor.embed.weight
        emb.normal_(0.0, 1.0 / math.sqrt(emb.shape[0]), generator=generator)
        for name, p in list(self.predictor.lstm.named_parameters()) + list(
            self.joint.named_parameters()
        ):
            if name.endswith("bias"):
                p.zero_()
            elif name.startswith("h"):
                nn.init.orthogonal_(p, generator=generator)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)

    @property
    def device(self) -> torch.device:
        return self.joint.out.weight.device

    def encode(self, feats, lens, deterministic=True, generator=None, pos_offset=0):
        """``(enc (N, T', d_model) float32, enc_lens (N,))``."""
        return self.encoder(feats, lens, deterministic, generator, pos_offset)

    def forward(
        self, feats, lens, refs, ref_lens, deterministic=True, generator=None,
        return_aux=False,
    ):
        """The mean transducer loss, or ``(loss, aux)`` with
        ``return_aux=True``: ``aux`` the encoder's mixture-of-experts
        load-balance losses, one per block (empty for a dense encoder)."""
        enc, enc_lens, aux = self.encoder(
            feats, lens, deterministic, generator, return_aux=True
        )
        refs = refs.to(enc.device).long()
        pred = self.predictor(refs)
        blank_lp, emit_lp = streamed_node_log_probs(self.joint, enc, pred, refs)
        loss = transducer_loss(blank_lp, emit_lp, enc_lens, ref_lens.to(enc.device))
        return (loss, aux) if return_aux else loss

    def greedy(self, feats, lens, max_symbols_per_frame: int = 4):
        """Greedy RNN-T decode: ``(hyps (N, U_max), hyp_lens (N,))``,
        ``U_max = max_symbols_per_frame * T'``."""
        with torch.no_grad():
            enc, enc_lens = self.encode(feats, lens)
            return transducer_greedy_search(
                enc, enc_lens, self.predictor.stepper(), self.joint,
                self.predictor.init_carry(enc.shape[0]), self.cfg.vocab_size,
                max_symbols_per_frame,
            )

    def beam(
        self,
        feats,
        lens,
        width: int = 4,
        max_symbols_per_frame: int = 4,
        lm=None,
        lm_weight: float = 0.3,
    ):
        """Time-synchronous RNN-T beam search: ``(hyps (N, W, U_max),
        hyp_lens (N, W), scores (N, W))`` best-first. ``lm`` shallow-fuses a
        :class:`~pydrobert_tpu_torch.lm.LookupLanguageModel` (adapted by
        :func:`lookup_lm_fusion`) or an ``(lm_step, init_lp, init_state)``
        triple."""
        with torch.no_grad():
            enc, enc_lens = self.encode(feats, lens)
            N = enc.shape[0]
            return transducer_beam_search(
                enc, enc_lens, self.predictor.stepper(), self.joint,
                self.predictor.init_carry(N), self.cfg.vocab_size, width,
                max_symbols_per_frame, _fusion(lm, self.cfg, N), lm_weight,
            )


def _fusion(lm, cfg: TransducerConfig, N: int):
    if lm is None or isinstance(lm, tuple):
        return lm
    if lm.vocab_size != cfg.vocab_size:
        raise RuntimeError(f"fused LM vocab {lm.vocab_size} != model vocab {cfg.vocab_size}")
    return lookup_lm_fusion(lm, N)


def _slab(joint: _Joint, enc_blk, pred, idx):
    """A slab of frames ``enc_blk (N, S, D)`` against every prefix ``pred
    (N, U + 1, P)``: blank ``(N, S, U + 1)`` and emit ``(N, S, U)``
    log-probabilities (``idx (N, 1, U, 1)`` the references)."""
    lp = torch.log_softmax(joint(enc_blk[:, :, None], pred[:, None]), -1)
    N, S, U1, _ = lp.shape
    emit = lp[:, :, : U1 - 1].gather(3, idx.expand(N, S, U1 - 1, 1))[..., 0]
    return lp[..., -1], emit


def streamed_node_log_probs(
    joint: _Joint, enc: torch.Tensor, pred: torch.Tensor, refs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streamed joint (the JAX package's ``_streamed_node_log_probs``):
    blank ``(N, T, U + 1)`` and emit ``(N, T, U)`` log-probabilities of
    ``enc (N, T, D)`` against ``pred (N, U + 1, P)``, a slab of as many
    frames as keep it within ``SLAB_ELEMENTS`` entries (at least one) at a
    time, each recomputed in the backward pass when gradients are on."""
    N, T, _ = enc.shape
    slab_frames = max(1, SLAB_ELEMENTS // (N * pred.shape[1] * joint.out.out_features))
    idx = refs.long()[:, None, :, None]
    blanks, emits = [], []
    for t0 in range(0, T, slab_frames):
        blk = enc[:, t0 : t0 + slab_frames]
        if torch.is_grad_enabled():
            b, e = checkpoint(_slab, joint, blk, pred, idx, use_reentrant=False)
        else:
            b, e = _slab(joint, blk, pred, idx)
        blanks.append(b)
        emits.append(e)
    return torch.cat(blanks, 1), torch.cat(emits, 1)


@torch.no_grad()
def streaming_transducer_greedy(
    model: ConformerTransducer,
    feats: torch.Tensor,
    lens: torch.Tensor,
    chunk: int,
    max_symbols_per_frame: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming greedy RNN-T recognition of a causal config
    (``attention_context=(L, 0)``, ``causal_conv=True``): chunked encoding
    with the receptive-field margin re-encoded, and the greedy carry
    threaded across chunks, so the hypotheses equal :meth:`ConformerTransducer.
    greedy`'s. ``(hyps (N, U_max), hyp_lens (N,))``, ``U_max =
    max_symbols_per_frame * ceil(T / 4)``."""
    T4, chunks = margin_chunks(
        model.encode, model.cfg.encoder, feats, lens, chunk, "streaming_transducer_greedy"
    )
    N = feats.shape[0]
    pred_step = model.predictor.stepper()
    carry = transducer_greedy_init(
        N, int(max_symbols_per_frame) * T4, pred_step,
        model.predictor.init_carry(N), model.cfg.vocab_size,
    )
    for enc, chunk_lens in chunks:
        carry = transducer_greedy_advance(
            enc, chunk_lens, pred_step, model.joint, model.cfg.vocab_size, carry,
            max_symbols_per_frame,
        )
    _, u, hyps, _, _ = carry
    return hyps, u


@torch.no_grad()
def streaming_transducer_beam(
    model: ConformerTransducer,
    feats: torch.Tensor,
    lens: torch.Tensor,
    chunk: int,
    width: int = 4,
    max_symbols_per_frame: int = 4,
    lm=None,
    lm_weight: float = 0.3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The beam counterpart of :func:`streaming_transducer_greedy`, equal
    to :meth:`ConformerTransducer.beam`: the beam carry (scores, buffers,
    predictor and LM states) threads across chunks. ``(hyps (N, W,
    U_max), hyp_lens (N, W), scores (N, W))`` best-first."""
    T4, chunks = margin_chunks(
        model.encode, model.cfg.encoder, feats, lens, chunk, "streaming_transducer_beam"
    )
    N = feats.shape[0]
    lm = _fusion(lm, model.cfg, N)
    pred_step = model.predictor.stepper()
    carry = transducer_beam_init(
        N, width, int(max_symbols_per_frame) * T4, pred_step,
        model.predictor.init_carry(N), model.cfg.vocab_size, lm,
    )
    for enc, chunk_lens in chunks:
        carry = transducer_beam_advance(
            enc, chunk_lens, pred_step, model.joint, model.cfg.vocab_size, carry,
            max_symbols_per_frame, lm_step=None if lm is None else lm[0], lm_weight=lm_weight,
        )
    return transducer_beam_finalize(carry)


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A :class:`ConformerTransducer` ``state_dict`` from the JAX package's
    flax parameters (the ``{"params": ...}`` dict or its entry), as nested
    dicts of numpy arrays: the encoder renamed as
    :func:`~pydrobert_tpu_torch.models.conformer.state_dict_from_jax` does,
    the embedding as is, dense kernels ``(in, out)`` transposed. Linear,
    so it also carries a gradient tree onto the port's ``.grad`` names."""
    params = params.get("params", params)
    out = _encoder_state_dict(params["encoder"], "encoder.")
    pred, joint = params["predictor"], params["joint"]
    out["predictor.embed.weight"] = np.asarray(pred["embed"]["embedding"])
    for name, p in pred["lstm"].items():  # hidden kernels have a bias
        out[f"predictor.lstm.{name}.weight"] = np.asarray(p["kernel"]).T
        if "bias" in p:
            out[f"predictor.lstm.{name}.bias"] = np.asarray(p["bias"])
    for name in ("enc_proj", "pred_proj", "out"):
        for k, v in _linear(joint[name]["kernel"], joint[name]["bias"]).items():
            out[f"joint.{name}.{k}"] = v
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in out.items()}


def make_transducer_train_step(
    model: ConformerTransducer,
    optimizer: torch.optim.Optimizer,
    augment: Optional[Callable] = None,
) -> Callable:
    """The training step: ``step(generator, feats, feat_lens, refs,
    ref_lens) -> loss``: ``augment`` (``(generator, feats, lens) ->
    feats``) when given, the forward with dropout on, the mean transducer
    loss through the streamed joint, its backward and one optimizer step.
    As :func:`~pydrobert_tpu_torch.models.conformer.make_train_step`, it
    updates ``model`` and ``optimizer`` in place and returns the detached
    loss; the same generator feeds the augmentation and every dropout
    site. A mixture-of-experts encoder adds ``moe_aux_weight`` times
    :func:`~pydrobert_tpu_torch.models.conformer.moe_aux_loss` to the
    loss."""
    enc = model.cfg.encoder

    def step(generator, feats, feat_lens, refs, ref_lens):
        if augment is not None:
            feats = augment(generator, feats, feat_lens)
        loss, aux = model(
            feats, feat_lens, refs, ref_lens, deterministic=False,
            generator=generator, return_aux=True,
        )
        if enc.num_experts > 1:
            loss = loss + enc.moe_aux_weight * moe_aux_loss(aux)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


# ---------------------------------------------------------------------------
# Tensor and pipeline parallelism (the JAX package's transducer helpers)
# ---------------------------------------------------------------------------


def transducer_partition_rules(path, leaf: torch.Tensor):
    """Tensor-parallel partition spec of a :class:`ConformerTransducer`
    parameter by its state dict name: the encoder's entries take
    :func:`~pydrobert_tpu_torch.models.conformer_partition_rules`; the
    joint's ``enc_proj`` and ``pred_proj`` split their output features and
    ``out`` its input features over ``model``; the embedding and the LSTM
    are replicated (its recurrence is serial)."""
    from ..parallel.mesh import MODEL_AXIS, PartitionSpec
    from .conformer import _names, conformer_partition_rules

    names = _names(path)
    if names and names[0] == "encoder":
        return conformer_partition_rules(names[1:], leaf)
    if leaf.dim() == 2 and names[-1] == "weight" and names[0] == "joint":
        if names[1] in ("enc_proj", "pred_proj"):
            return PartitionSpec(MODEL_AXIS, None)
        if names[1] == "out":
            return PartitionSpec(None, MODEL_AXIS)
    return PartitionSpec()


def transducer_stack_block_params(params: Dict[str, torch.Tensor], pipeline_parallelism: int):
    """A :class:`ConformerTransducer` state dict in pipeline form: the
    encoder's ``block_i`` entries stacked stage-major into
    ``encoder.blocks.*`` (:func:`~pydrobert_tpu_torch.models.
    stack_block_params`); the predictor and joint entries unchanged."""
    from .conformer import _stack

    return _stack(params, pipeline_parallelism, "encoder.")


def transducer_unstack_block_params(pparams: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`transducer_stack_block_params`."""
    from .conformer import _unstack

    return _unstack(pparams, "encoder.")


def transducer_pipeline_partition_rules(path, leaf: torch.Tensor):
    """Partition rules of pipeline-form transducer parameters: the encoder's
    block stacks split their stage axis over ``pipe``; everything else
    keeps :func:`transducer_partition_rules`' layout."""
    from ..parallel.mesh import PartitionSpec
    from ..parallel.pipeline import PIPE_AXIS
    from .conformer import _names

    names = _names(path)
    if len(names) >= 2 and names[0] == "encoder" and names[1] == "blocks":
        return PartitionSpec(PIPE_AXIS)
    return transducer_partition_rules(path, leaf)


class _Decoder(nn.Module):
    """The predictor and the joint's node log-probabilities over the whole
    utterance in one slab, for :func:`torch.func.functional_call`."""

    def __init__(self, model: ConformerTransducer):
        super().__init__()
        self.predictor = model.predictor
        self.joint = model.joint

    def forward(self, enc, refs):
        refs = refs.to(enc.device).long()
        pred = self.predictor(refs)
        return _slab(self.joint, enc, pred, refs[:, None, :, None])


def make_transducer_pipeline_train_step(
    model: ConformerTransducer,
    optimizer: torch.optim.Optimizer,
    mesh,
    n_microbatches: int,
    augment: Optional[Callable] = None,
) -> Callable:
    """The pipeline-parallel :func:`make_transducer_train_step`:
    ``step(pparams, generator, feats, feat_lens, refs, ref_lens) -> loss``,
    ``pparams`` the pipeline-form tensors
    (:func:`transducer_stack_block_params`) that ``optimizer`` updates. The
    encoder's block stack runs as GPipe stages over ``mesh``'s ``pipe``
    axis (:func:`~pydrobert_tpu_torch.models.pipelined_encoder_forward`);
    the predictor, the joint and the transducer loss run after it on every
    rank, the joint in one slab (the streamed joint's recomputation would
    read the model's own parameters). Deterministic: dropout is not applied
    (regularize via ``augment``)."""
    from .conformer import _prefixed, _warn_pipeline_dropout, pipelined_encoder_forward

    cfg = model.cfg
    _warn_pipeline_dropout(cfg.encoder)
    dec = _Decoder(model)

    def step(pparams, generator, feats, feat_lens, refs, ref_lens):
        if augment is not None:
            feats = augment(generator, feats, feat_lens)
        x, _, out_lens = pipelined_encoder_forward(
            cfg.encoder, _prefixed(pparams, "encoder."), feats, feat_lens, mesh, n_microbatches
        )
        dec_params = {k: v for k, v in pparams.items() if not k.startswith("encoder.")}
        blank_lp, emit_lp = torch.func.functional_call(dec, dec_params, (x.float(), refs))
        loss = transducer_loss(blank_lp, emit_lp, out_lens, ref_lens.to(x.device))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
