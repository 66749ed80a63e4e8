"""Sequential language models and shallow fusion (counterpart of
:mod:`pydrobert_tpu.lm`).

The protocol classes (:class:`SequentialLanguageModel` and its extractable
and mixable variants, the :class:`ShallowFusionLanguageModel` family) are
plain classes over tensors: ``hist`` is an integer tensor ``(S, N)``,
``idx`` an int or an ``(N,)`` tensor, and LM state a dict of tensors
(empty for :class:`LookupLanguageModel`). Beam reordering and fusion
selection act on every state leaf by default
(:mod:`pydrobert_tpu_torch.utils.pytree`).

:class:`LookupLanguageModel` keeps the JAX package's tables: the host-side
build is the same numpy code, so the tables, and the state dict that
carries them (:meth:`LookupLanguageModel.state_dict`), are the JAX LM's,
slot for slot. Device queries are torch ops on the LM's device. The FNV
hashing that picks probe slots runs in int64 masked to 32 bits, in place
of the JAX package's uint32 wraparound.
"""

import abc
import warnings
from logging import Logger
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import argcheck, config, default_device
from .utils import pytree as _pytree

__all__ = [
    "ExtractableSequentialLanguageModel",
    "ExtractableShallowFusionLanguageModel",
    "LookupLanguageModel",
    "MixableSequentialLanguageModel",
    "MixableShallowFusionLanguageModel",
    "SequentialLanguageModel",
    "ShallowFusionLanguageModel",
]

StateDict = Dict[str, Any]


class SequentialLanguageModel(abc.ABC):
    """Distribution over the next token in a sequence.

    Subclasses implement :meth:`calc_idx_log_probs`; the default
    :meth:`calc_full_log_probs` iterates it. Calling the model with ``idx``
    set returns ``(log_probs_idx, next_state)``; with ``idx=None`` it
    returns the stacked ``(S + 1, N, vocab_size)`` log probabilities.
    """

    vocab_size: int

    def __init__(self, vocab_size: int):
        self.vocab_size = argcheck.is_posi(vocab_size, "vocab_size")

    def update_input(self, prev: StateDict, hist: torch.Tensor) -> StateDict:
        """Populate the initial state before any log-probability queries.
        Must be idempotent."""
        return prev

    @abc.abstractmethod
    def calc_idx_log_probs(
        self, hist: torch.Tensor, prev: StateDict, idx
    ) -> Tuple[torch.Tensor, StateDict]:
        """Log probs ``(N, vocab_size)`` over token ``idx`` given
        ``hist[:idx]``; ``prev`` is the state after ``idx - 1`` and the
        returned state the state after ``idx``."""

    def calc_full_log_probs(self, hist: torch.Tensor, prev: StateDict) -> torch.Tensor:
        """Stacked log probs over all ``S + 1`` prefixes of ``hist``."""
        log_probs = []
        for idx in range(hist.shape[0] + 1):
            log_probs_idx, prev = self.calc_idx_log_probs(hist, prev, idx)
            log_probs.append(log_probs_idx)
        return torch.stack(log_probs, 0)

    def __call__(self, hist, prev: Optional[StateDict] = None, idx=None):
        prev = {} if prev is None else prev
        hist = torch.as_tensor(hist)
        if hist.dim() != 2:
            raise RuntimeError("hist must be 2 dimensional")
        S, N = hist.shape
        prev = self.update_input(prev, hist)
        if idx is None:
            return self.calc_full_log_probs(hist, prev)
        idx_ = torch.as_tensor(idx, dtype=torch.long)
        if idx_.dim() == 1 and idx_.shape[0] == 1:
            idx_ = idx_[0]
        elif idx_.dim() == 1 and idx_.shape[0] != N:
            raise RuntimeError(
                f"Expected dim 0 of idx to be of size {N}, got {idx_.shape[0]}"
            )
        idx_ = (idx_ + S + 1) % (S + 1)
        return self.calc_idx_log_probs(hist, prev, idx_)


class ExtractableSequentialLanguageModel(SequentialLanguageModel):
    """An LM whose state can be reordered or subsampled along the batch
    axis (needed by searches that shuffle beams). The default indexes every
    state leaf's first axis."""

    def extract_by_src(self, prev: StateDict, src: torch.Tensor) -> StateDict:
        return _pytree.extract_by_src(prev, src)


class MixableSequentialLanguageModel(ExtractableSequentialLanguageModel):
    """An LM whose states can be mixed elementwise along the batch axis
    (needed by :class:`~pydrobert_tpu_torch.ops.decoding.CTCPrefixSearch`
    fusion)."""

    def mix_by_mask(
        self, prev_true: StateDict, prev_false: StateDict, mask: torch.Tensor
    ) -> StateDict:
        return _pytree.mix_by_mask(prev_true, prev_false, mask)


class ShallowFusionLanguageModel(SequentialLanguageModel):
    """Log-linear combination of two LMs: ``first + beta * second``, their
    states kept in one dict under the key prefixes ``first_prefix`` and
    ``second_prefix``."""

    def __init__(
        self,
        first: SequentialLanguageModel,
        second: SequentialLanguageModel,
        beta: float = 0.0,
        first_prefix: str = "first.",
        second_prefix: str = "second.",
    ):
        if first.vocab_size != second.vocab_size:
            raise ValueError(
                "first and second vocab_size must match, got "
                f"{first.vocab_size} and {second.vocab_size}"
            )
        if first_prefix == second_prefix:
            raise ValueError("first_prefix and second_prefix cannot match")
        super().__init__(first.vocab_size)
        self.first, self.second = first, second
        self.beta = argcheck.is_float(beta, "beta")
        self.first_prefix = argcheck.is_str(first_prefix, "first_prefix")
        self.second_prefix = argcheck.is_str(second_prefix, "second_prefix")

    def split_dicts(self, prev: StateDict) -> Tuple[StateDict, StateDict]:
        prev_first, prev_second = {}, {}
        for k, v in prev.items():
            if k.startswith(self.first_prefix):
                prev_first[k[len(self.first_prefix):]] = v
            elif k.startswith(self.second_prefix):
                prev_second[k[len(self.second_prefix):]] = v
            else:
                raise RuntimeError(
                    f"key '{k}' from prev does not start with first_prefix "
                    f"'{self.first_prefix}' nor second_prefix "
                    f"'{self.second_prefix}'"
                )
        return prev_first, prev_second

    def merge_dicts(self, prev_first: StateDict, prev_second: StateDict) -> StateDict:
        prev = {self.first_prefix + k: v for k, v in prev_first.items()}
        prev.update((self.second_prefix + k, v) for k, v in prev_second.items())
        return prev

    def update_input(self, prev: StateDict, hist: torch.Tensor) -> StateDict:
        a, b = self.split_dicts(prev)
        return self.merge_dicts(
            self.first.update_input(a, hist), self.second.update_input(b, hist)
        )

    def calc_idx_log_probs(self, hist, prev, idx):
        a, b = self.split_dicts(prev)
        lp_a, cur_a = self.first.calc_idx_log_probs(hist, a, idx)
        lp_b, cur_b = self.second.calc_idx_log_probs(hist, b, idx)
        return lp_a + self.beta * lp_b, self.merge_dicts(cur_a, cur_b)

    def calc_full_log_probs(self, hist, prev):
        a, b = self.split_dicts(prev)
        return self.first.calc_full_log_probs(
            hist, a
        ) + self.beta * self.second.calc_full_log_probs(hist, b)


class ExtractableShallowFusionLanguageModel(
    ShallowFusionLanguageModel, ExtractableSequentialLanguageModel
):
    """Shallow fusion of two extractable LMs."""

    def extract_by_src(self, prev: StateDict, src: torch.Tensor) -> StateDict:
        a, b = self.split_dicts(prev)
        return self.merge_dicts(
            self.first.extract_by_src(a, src), self.second.extract_by_src(b, src)
        )


class MixableShallowFusionLanguageModel(
    ExtractableShallowFusionLanguageModel, MixableSequentialLanguageModel
):
    """Shallow fusion of two mixable LMs."""

    def mix_by_mask(
        self, prev_true: StateDict, prev_false: StateDict, mask: torch.Tensor
    ) -> StateDict:
        at, bt = self.split_dicts(prev_true)
        af, bf = self.split_dicts(prev_false)
        return self.merge_dicts(
            self.first.mix_by_mask(at, af, mask),
            self.second.mix_by_mask(bt, bf, mask),
        )


# ---------------------------------------------------------------------------
# LookupLanguageModel: backoff n-gram model over open-addressing hash tables
# ---------------------------------------------------------------------------

_EMPTY_KEY = np.int32(np.iinfo(np.int32).min)
_FNV_BASIS = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)
_FIN_MUL = 0x85EBCA6B
_M32 = 0xFFFFFFFF


def _fnv_mix_np(h: np.ndarray, x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return (h ^ x.astype(np.uint32)) * _FNV_PRIME


def _fnv_fin_np(h: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(_FIN_MUL)
        return h ^ (h >> np.uint32(13))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` and ``c`` in ``[0, 2**32)``,
    with no product past 2**48 (so no int64 overflow): the low and high
    16-bit halves of ``h`` are multiplied apart."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fnv_mix_t(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`_fnv_mix_np` on int64 tensors holding uint32 values; ``x``
    is an int token (negative ids wrap as a uint32 cast does)."""
    return _mul32(h ^ (x.long() & _M32), int(_FNV_PRIME))


def _fnv_fin_t(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 15)
    h = _mul32(h, _FIN_MUL)
    return h ^ (h >> 13)


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    """The float32 whose bits an int32 tensor holds."""
    return x.contiguous().view(torch.float32)


_DENSE_CTX_MAX_ROWS = 1 << 21
"""Largest ``base**n`` for which a context table also stores a directly
indexed dense row array (one gather a lookup) besides the probing hash
table; the same bound as the JAX package, so the two packages build the
same layouts."""


class _CtxTable:
    """Hash table over contexts: ``ctx (n ids) -> (logb, row_start,
    row_len)`` plus CSR children arrays ``(tok, logp)`` grouped by
    context, and a dense direct-indexed copy of the rows when ``base**n``
    is small. The numpy build is the JAX package's; the device copies live
    on ``device``."""

    def __init__(
        self,
        entries: Dict[Tuple[int, ...], Tuple[float, int, int]],
        child_tok: np.ndarray,
        child_logp: np.ndarray,
        n: int,
        max_children: int,
        base: int = 0,
        uni: Optional[np.ndarray] = None,
        device: torch.device = torch.device("cpu"),
    ):
        self.uni = uni
        self.device = device
        count = len(entries)
        # 4x load headroom keeps probe chains short
        size = 1 << max(1, (max(4 * count, 2) - 1).bit_length())
        keys = np.full((size, n), _EMPTY_KEY, np.int32)
        fvals = np.zeros((size,), np.float32)
        ivals = np.zeros((size, 2), np.int32)
        mask = np.uint32(size - 1)
        max_probe = 0
        for key, (logb, start, length) in entries.items():
            h = _FNV_BASIS
            for tok in key:
                h = _fnv_mix_np(h, np.uint32(np.int64(tok)))
            h = _fnv_fin_np(h)
            # double hashing: an odd, hash-derived stride
            step = int((h >> np.uint32(16)) | np.uint32(1))
            probe = 1
            slot = int(h & mask)
            while keys[slot, 0] != _EMPTY_KEY:
                slot = (slot + step) & int(mask)
                probe += 1
            keys[slot] = key
            fvals[slot] = logb
            ivals[slot] = (start, length)
            max_probe = max(max_probe, probe)
        self.n, self.size, self.max_probe = n, size, max_probe
        self.keys, self.fvals, self.ivals = keys, fvals, ivals
        self.child_tok = child_tok
        self.child_logp = child_logp
        self.max_children = int(max_children)
        self.base = int(base)
        self._pack()

    def set_logz(self, logzs: Dict[Tuple[int, ...], float]) -> None:
        """Attach per-context exact normalizers (slot-aligned) and repack."""
        lz = np.zeros((self.size,), np.float32)
        occupied = self.keys[:, 0] != _EMPTY_KEY
        for slot in np.nonzero(occupied)[0]:
            key = tuple(int(t) for t in self.keys[slot])
            if key in logzs:
                lz[slot] = logzs[key]
        self.logz_slot = lz
        self._pack()

    def _pack(self):
        """Fuse per-slot data into single rows: ``packed (size, n + 3)``
        int32 = ``[key tokens..., logb bits, row_start, row_len]``;
        ``child_packed (rows, 2 or 3)`` = ``[token, logp bits, unigram
        logp bits]``; with ``base**n`` small, ``dense_packed (base**n, 3 or
        4)`` = ``[logb bits, row_start, row_len, logZ bits]`` indexed by the
        flat context id. Then copy them to the device."""
        self.packed = np.concatenate(
            [self.keys, self.fvals[:, None].view(np.int32), self.ivals], 1
        )
        ct = self.child_tok if len(self.child_tok) else np.zeros(1, np.int32)
        cl = self.child_logp if len(self.child_logp) else np.zeros(1, np.float32)
        cols = [ct, cl.view(np.int32)]
        if getattr(self, "uni", None) is not None:
            cu = self.uni[np.clip(ct, 0, len(self.uni) - 1)].astype(np.float32)
            cols.append(cu.view(np.int32))
        self.child_packed = np.stack(cols, 1)
        self.dense_packed = None
        if 0 < self.base and self.base ** self.n <= _DENSE_CTX_MAX_ROWS:
            rows = self.base ** self.n
            lz = getattr(self, "logz_slot", None)
            dense = np.zeros((rows, 3 if lz is None else 4), np.int32)
            occupied = self.keys[:, 0] != _EMPTY_KEY
            flat = np.zeros((occupied.sum(),), np.int64)
            kk = self.keys[occupied].astype(np.int64)
            for j in range(self.n):
                flat = flat * self.base + kk[:, j]
            dense[flat, 0] = self.fvals[occupied].view(np.int32)
            dense[flat, 1:3] = self.ivals[occupied]
            if lz is not None:
                dense[flat, 3] = lz[occupied].view(np.int32)
            # the default row (logb +0.0 bits, len 0) reads as absent
            self.dense_packed = dense
        self.to(self.device)

    def to(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self.packed_t = torch.as_tensor(self.packed, device=self.device)
        self.child_t = torch.as_tensor(self.child_packed, device=self.device)
        self.dense_t = (
            None
            if self.dense_packed is None
            else torch.as_tensor(self.dense_packed, device=self.device)
        )

    def lookup_ctx(self, qkeys: torch.Tensor):
        """``(found, logb, start, length)`` for query contexts ``(B, n)``."""
        n = self.n
        qkeys = qkeys.long()
        if self.dense_t is not None:
            flat = torch.zeros(qkeys.shape[:-1], dtype=torch.long, device=qkeys.device)
            in_range = torch.ones(qkeys.shape[:-1], dtype=torch.bool, device=qkeys.device)
            for j in range(n):
                q = qkeys[..., j]
                in_range = in_range & (q >= 0) & (q < self.base)
                flat = flat * self.base + q.clamp(0, self.base - 1)
            row = self.dense_t[flat]
            # out-of-range tokens read as not found (the probing path sees
            # a key mismatch); the clamp would alias them onto stored rows
            length = torch.where(in_range, row[..., 2], 0)
            logb = torch.where(in_range, _as_f32(row[..., 0]), 0.0)
            found = (length > 0) | (logb != 0.0)
            return found, logb, row[..., 1], length
        h = torch.full(qkeys.shape[:-1], int(_FNV_BASIS), dtype=torch.long, device=qkeys.device)
        for j in range(n):
            h = _fnv_mix_t(h, qkeys[..., j])
        h = _fnv_fin_t(h)
        mask = self.size - 1
        step = (h >> 16) | 1
        found = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
        row = torch.zeros(h.shape + (3,), dtype=torch.int32, device=h.device)
        for d in range(self.max_probe):
            # (h + d * step) mod 2**32, then the table mask: mask < 2**32,
            # so the low bits of the int64 sum are the uint32 sum's
            slot = (h + d * step) & mask
            r = self.packed_t[slot]  # (B, n + 3)
            match = (r[..., :n].long() == qkeys).all(-1) & ~found
            row = torch.where(match[..., None], r[..., n:], row)
            found = found | match
        return found, _as_f32(row[..., 0]), row[..., 1], row[..., 2]

    def _children(self, start, length, found):
        """``(pos, valid)`` of each context's ``max_children`` child rows."""
        S = self.max_children
        rows = self.child_packed.shape[0]
        ar = torch.arange(S, device=start.device)
        pos = (start.long()[:, None] + ar[None]).clamp(0, rows - 1)
        valid = (ar[None] < length[:, None]) & found[:, None]
        return pos, valid

    def probe_children(self, qkeys: torch.Tensor):
        """Per-context children as padded lists: ``(found, logb, toks (B,
        S), logps (B, S), valid (B, S), unis (B, S))`` for query contexts
        ``(B, n)``, ``S = max_children``; ``unis`` are the children's
        unigram log-probs baked into the rows, or None."""
        found, logb, start, length = self.lookup_ctx(qkeys)
        B = qkeys.shape[0]
        dev = qkeys.device
        has_uni = self.child_packed.shape[1] > 2
        if self.max_children == 0:
            z = torch.zeros((B, 0), dtype=torch.float32, device=dev)
            return (
                found, logb, torch.zeros((B, 0), dtype=torch.int32, device=dev), z,
                torch.zeros((B, 0), dtype=torch.bool, device=dev), z if has_uni else None,
            )
        pos, valid = self._children(start, length, found)
        got = self.child_t[pos]  # (B, S, 2 or 3)
        unis = _as_f32(got[..., 2]) if has_uni else None
        return found, logb, got[..., 0], _as_f32(got[..., 1]), valid, unis

    def extend_scores(self, qkeys: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
        """Scores over all ``V`` extensions of contexts ``(B, n)``:
        children's stored log-probs where present, else ``base + logb``."""
        B, V = base.shape
        found, logb, start, length = self.lookup_ctx(qkeys)
        out = base + torch.where(found, logb, 0.0)[:, None]
        if self.max_children == 0:
            return out
        pos, valid = self._children(start, length, found)
        got = self.child_t[pos]
        # invalid children land in a spare column V; (context, token)
        # pairs are unique, so the order of the writes is moot
        toks = torch.where(valid, got[..., 0], V).long()
        out = torch.cat([out, out.new_zeros((B, 1))], 1)
        out.scatter_(1, toks, _as_f32(got[..., 1]))
        return out[:, :V]


class LookupLanguageModel(MixableSequentialLanguageModel):
    r"""Backoff n-gram language model from a fixed lookup table.

    Computes :math:`\Pr(w_t | w_{t-1}, \ldots, w_{t-(N-1)})` from stored
    n-gram log-probabilities, backing off to shorter histories with a
    penalty when the full n-gram is absent; missing entries have
    probability 0 and missing backoff penalties 1. Histories shorter than
    ``N - 1`` are padded with ``sos``.

    Each n-gram order is an open-addressing hash table in flat arrays (and
    a directly indexed dense copy when the context space is small), the
    JAX package's layout: a query for all ``V`` extensions of a batch of
    histories is a fixed number of gathers per order. The tables live on
    ``device`` (``None`` means ``cuda``); the state dict holds the host
    arrays, the JAX LM's :meth:`state_dict` loads unchanged, and so does
    one saved before stored normalizers.

    Stateless as a sequential LM: the state dict is empty and histories are
    re-queried each step.
    """

    def __init__(
        self,
        vocab_size: int,
        sos: int,
        prob_dicts: Optional[List[dict]] = None,
        destructive: bool = False,
        logger: Optional[Logger] = None,
        device: Union[str, torch.device, None] = None,
    ):
        super().__init__(vocab_size)
        self.device = default_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the index tensors on it report, so searches can compare them
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.sos = argcheck.is_int(sos, "sos")
        info = logger.info if logger is not None else (lambda msg: None)
        V = vocab_size
        if prob_dicts is None:
            prob_dicts = [{w: -float(np.log(V)) for w in range(V)}]
        elif not len(prob_dicts):
            raise ValueError("prob_dicts must contain at least unigrams")
        elif not destructive:
            prob_dicts = [d.copy() for d in prob_dicts]
        N = self.max_ngram = len(prob_dicts)
        if not prob_dicts[-1]:
            raise ValueError("Final element in prob_dicts must not be empty")
        valid_ids = set(range(V))
        valid_ids.add(sos)
        # validate ids and auto-complete missing contexts with (-inf, 0.0)
        for n in range(N - 1, -1, -1):
            info(f"checking prob_dict of order {n + 1}")
            prob_dict = prob_dicts[n]
            if n == 0:
                extra = set(prob_dict) - valid_ids
                if extra:
                    raise ValueError(
                        f"Unexpected unigrams in prob_dicts: {extra} "
                        "(are these ids?)"
                    )
            else:
                for seq in list(prob_dict):
                    if not isinstance(seq, tuple) or len(seq) != n + 1:
                        raise ValueError(
                            f"Key {seq} in {n + 1}-gram is not a sequence of "
                            f"length {n + 1}"
                        )
                    extra = set(seq) - valid_ids
                    if extra:
                        raise ValueError(
                            f"Unexpected tokens in {n + 1}-gram in "
                            f"prob_dicts: {extra} (are these ids?)"
                        )
                    suffix = seq[1:] if len(seq) > 2 else seq[1]
                    if suffix not in prob_dicts[n - 1]:
                        prob_dicts[n - 1][suffix] = (-float("inf"), 0.0)
        # dense unigram log-probs over [0, V); sos's unigram is never
        # queried (it is no next token in [0, V)) but its backoff is
        uni = np.full((V,), -np.inf, np.float32)
        for w, val in prob_dicts[0].items():
            logp = val[0] if N > 1 else val
            if isinstance(logp, tuple):  # unigram-only model with backoffs
                logp = logp[0]
            if 0 <= w < V:
                uni[w] = logp
        self._uni_logp = uni
        self._sum_u = float(np.exp(uni[np.isfinite(uni)]).sum())
        # one table per context order n (1..N-1): backoff + CSR span over
        # the order-(n+1) continuations of that context
        self._ctx_tables: List[_CtxTable] = []
        kid_maps: List[Dict[Tuple[int, ...], List[Tuple[int, float]]]] = []
        logb_maps: List[Dict[Tuple[int, ...], float]] = []
        for n in range(0, N - 1):
            children: Dict[Tuple[int, ...], List[Tuple[int, float]]] = {}
            for key, val in prob_dicts[n + 1].items():
                logp = float(val[0]) if n + 1 < N - 1 else float(
                    val if not isinstance(val, tuple) else val[0]
                )
                if not np.isfinite(logp):
                    continue
                if not 0 <= int(key[-1]) < V:
                    # grams predicting a non-vocab token (ending in sos)
                    # are never queried as extensions
                    continue
                ctx = tuple(key[:-1])
                children.setdefault(ctx, []).append((int(key[-1]), logp))
            entries: Dict[Tuple[int, ...], Tuple[float, int, int]] = {}
            tok_rows: List[int] = []
            logp_rows: List[float] = []
            max_children = 0
            ctxs = set(children)
            for key, val in prob_dicts[n].items():
                key_t = (key,) if n == 0 else tuple(key)
                if float(val[1]) != 0.0:
                    ctxs.add(key_t)
            for ctx in sorted(ctxs):
                val = prob_dicts[n].get(ctx[0] if n == 0 else ctx)
                logb = float(val[1]) if val is not None else 0.0
                kids = children.get(ctx, [])
                entries[ctx] = (logb, len(tok_rows), len(kids))
                max_children = max(max_children, len(kids))
                for tok, logp in kids:
                    tok_rows.append(tok)
                    logp_rows.append(logp)
            info(
                f"building context table of order {n + 1} "
                f"({len(entries)} contexts, {len(tok_rows)} continuations)"
            )
            self._ctx_tables.append(
                _CtxTable(
                    entries,
                    np.asarray(tok_rows, np.int32),
                    np.asarray(logp_rows, np.float32),
                    n + 1,
                    max_children,
                    base=(max(V, sos) + 1) if sos >= 0 else 0,
                    uni=uni,
                    device=self.device,
                )
            )
            kid_maps.append(children)
            logb_maps.append({ctx: lbs for ctx, (lbs, _, _) in entries.items()})
        self._store_logzs(kid_maps, logb_maps)
        self._reset_caches()

    def _reset_caches(self):
        self._combined_cache = None
        self._combined_dev = None
        self._order2_cache = None
        self._order2_dev = None
        self._uni_t = torch.as_tensor(self._uni_logp, device=self.device)

    def _store_logzs(self, kid_maps, logb_maps) -> None:
        """The exact normalizer of every stored context's full conditional
        distribution (float64, host-side, bottom-up by context length),
        stored in the tables. An absent context's distribution equals its
        suffix context's (backoff weight 1), so "highest stored order wins,
        else next" is exact on the query side."""
        uni = self._uni_logp.astype(np.float64)
        sum_u = float(np.exp(uni[np.isfinite(uni)]).sum())
        kid_dicts = [{ctx: dict(kids) for ctx, kids in m.items()} for m in kid_maps]

        def value(v: int, ctx: Tuple[int, ...]) -> float:
            """lm(v | ctx), walking the backoff chain (earliest-first)."""
            pen = 0.0
            for L in range(len(ctx), 0, -1):
                sub = ctx[len(ctx) - L:]
                logp = kid_dicts[L - 1].get(sub, {}).get(v)
                if logp is not None:
                    return pen + logp
                pen += logb_maps[L - 1].get(sub, 0.0)
            return pen + float(uni[v])

        zmemo: Dict[Tuple[int, ...], float] = {(): sum_u}

        def zof(ctx: Tuple[int, ...]) -> float:
            if ctx in zmemo:
                return zmemo[ctx]
            L = len(ctx)
            if L == 0:
                return sum_u
            kids = kid_maps[L - 1].get(ctx)
            logb = logb_maps[L - 1].get(ctx)
            if kids is None and logb is None:
                z = zof(ctx[1:])
            else:
                parent = ctx[1:]
                zp = zof(parent)
                child_mass = replaced = 0.0
                for tok, logp in kids or ():
                    child_mass += float(np.exp(logp))
                    replaced += float(np.exp(value(tok, parent)))
                z = child_mass + float(np.exp(logb or 0.0)) * max(zp - replaced, 0.0)
            zmemo[ctx] = z
            return z

        for L in range(1, len(self._ctx_tables) + 1):
            table = self._ctx_tables[L - 1]
            logzs = {}
            for ctx in set(kid_maps[L - 1]) | set(logb_maps[L - 1]):
                logzs[ctx] = float(np.log(max(zof(ctx), 1e-300)))
            table.set_logz(logzs)

    def extract_by_src(self, prev: StateDict, src: torch.Tensor) -> StateDict:
        return prev

    def mix_by_mask(self, prev_true, prev_false, mask) -> StateDict:
        return prev_true

    def _context(self, hist: torch.Tensor, idx) -> torch.Tensor:
        """Last ``N - 1`` tokens before ``idx``, sos-padded: ``(N - 1,
        B)``, most recent first."""
        S, B = hist.shape
        N = self.max_ngram
        dev = hist.device
        if isinstance(idx, int):  # filled on the device: no host copy, no sync
            idxs = torch.full((B,), idx, dtype=torch.long, device=dev)
        else:
            idxs = torch.as_tensor(idx, dtype=torch.long, device=dev).expand(B)
        pos = idxs[None, :] - 1 - torch.arange(N - 1, device=dev)[:, None]
        if S == 0:
            return torch.full((N - 1, B), self.sos, dtype=torch.long, device=dev)
        gathered = hist[pos.clamp(0, S - 1), torch.arange(B, device=dev)[None, :]]
        return torch.where(pos >= 0, gathered.long(), self.sos)

    def _log_probs_at(self, ctx: torch.Tensor) -> torch.Tensor:
        """``(B, V)`` log probs for contexts ``(N - 1, B)``, most recent
        first."""
        B = ctx.shape[1]
        lp = self._uni_t.expand(B, self.vocab_size)
        for n in range(2, self.max_ngram + 1):
            # context tokens earliest-first: (w_{t-n+1}, ..., w_{t-1})
            ctx_n = ctx[: n - 1].flip(0).T
            lp = self._ctx_tables[n - 2].extend_scores(ctx_n, lp)
        return lp.contiguous()

    def calc_idx_log_probs(self, hist, prev: StateDict, idx):
        hist = torch.as_tensor(hist, device=self.device)
        if hist.dim() != 2:
            raise RuntimeError("hist must be 2 dimensional")
        B = hist.shape[1]
        if self.max_ngram == 1:
            return self._uni_t.expand(B, self.vocab_size).clone(), prev
        return self._log_probs_at(self._context(hist, idx)), prev

    def calc_full_log_probs(self, hist, prev: StateDict) -> torch.Tensor:
        return self.calc_full_log_probs_chunked(hist, prev, None)

    def calc_full_log_probs_chunked(
        self, hist, prev: StateDict, chunk_size: Optional[int] = 32
    ) -> torch.Tensor:
        """Like :meth:`calc_full_log_probs`, bounding memory by querying
        ``chunk_size`` history positions at a time (all at once with
        None)."""
        hist = torch.as_tensor(hist, device=self.device)
        S, B = hist.shape
        V = self.vocab_size
        total = S + 1
        chunk = total if chunk_size is None else max(1, int(chunk_size))
        if self.max_ngram == 1:
            return self._uni_t.expand(total, B, V).clone()
        out = []
        for t0 in range(0, total, chunk):
            ts = range(t0, min(t0 + chunk, total))
            # contexts of positions ts for every batch row, flattened
            ctx = torch.stack([self._context(hist, t) for t in ts], 1)
            ctx = ctx.reshape(self.max_ngram - 1, -1)  # (N - 1, c * B)
            out.append(self._log_probs_at(ctx).reshape(len(ts), B, V))
        return torch.cat(out, 0)

    # -- sparse structure for slot-based decoding ---------------------------
    @property
    def max_corrections(self) -> int:
        """Static bound on per-context non-unigram token corrections."""
        return sum(t.max_children for t in self._ctx_tables)

    def _combined_tables(self):
        """All orders' dense context rows (and child rows) stacked into
        single arrays, with build-time shadow bitmasks, exactly as the JAX
        package builds them; None when any order lacks a dense table with
        stored normalizers.

        A lower-order child slot is shadowed when its token also appears
        among a found higher-order context's children (the highest stored
        order wins). That membership depends only on the two stored
        contexts, one a suffix of the other, so order-j rows carry
        ``ceil(s_i / 32)`` int32 words per lower order i, bit c of pair
        (i, j) set iff slot c of the lower context's child list is
        shadowed."""
        if self.max_ngram == 1:
            return None
        if any(
            t.dense_packed is None or t.dense_packed.shape[1] != 4
            for t in self._ctx_tables
        ):
            return None
        cached = self._combined_cache
        if cached is None:
            row_offs, parts, child_offs, ctoks, clps = [], [], [], [], []
            off = coff = 0
            for t in self._ctx_tables:
                row_offs.append(off)
                parts.append(t.dense_packed)
                off += t.dense_packed.shape[0]
                child_offs.append(coff)
                ct = t.child_tok if len(t.child_tok) else np.zeros(1, np.int32)
                cl = t.child_logp if len(t.child_logp) else np.zeros(1, np.float32)
                ctoks.append(np.ascontiguousarray(ct, np.int32))
                clps.append(np.ascontiguousarray(cl, np.float32))
                coff += len(ct)
            s_list = [t.max_children for t in self._ctx_tables]
            nt = len(self._ctx_tables)
            words = [max(1, -(-s // 32)) for s in s_list]
            dup_cols = [dict() for _ in range(nt)]
            for j in range(1, nt):
                col = 4
                for i in range(j):
                    dup_cols[j][i] = (col, words[i])
                    col += words[i]
            R = 4 + (sum(words[: nt - 1]) if nt > 1 else 0)
            base = self._ctx_tables[0].base
            radix = np.int64(self.vocab_size + 2)
            for j in range(1, nt):
                dj = parts[j]
                wide = np.zeros((dj.shape[0], R), np.int32)
                wide[:, : dj.shape[1]] = dj
                wide_u = wide.view(np.uint32)
                occ = np.nonzero(dj[:, 2] > 0)[0]
                for i in range(j):
                    if not len(occ):
                        break
                    di = parts[i]
                    # lower context flat id = suffix of the higher one in
                    # most-recent-first coordinates
                    lor = occ % (base ** (i + 1))
                    li = di[lor, 2]
                    sel = li > 0
                    occ2, lor2 = occ[sel], lor[sel]
                    if not len(occ2):
                        continue
                    li2 = di[lor2, 2].astype(np.int64)
                    si2 = di[lor2, 1].astype(np.int64)
                    lj2 = dj[occ2, 2].astype(np.int64)
                    sj2 = dj[occ2, 1].astype(np.int64)
                    # flat (pair row, token) keys for both sides
                    rep = np.repeat(np.arange(len(occ2)), li2)
                    offs = np.concatenate([[0], np.cumsum(li2)])
                    slot = np.arange(offs[-1], dtype=np.int64) - offs[rep]
                    lo_tok = ctoks[i][si2[rep] + slot].astype(np.int64)
                    key_lo = rep.astype(np.int64) * radix + lo_tok
                    hrep = np.repeat(np.arange(len(occ2)), lj2)
                    hoffs = np.concatenate([[0], np.cumsum(lj2)])
                    hslot = np.arange(hoffs[-1], dtype=np.int64) - hoffs[hrep]
                    hi_tok = ctoks[j][sj2[hrep] + hslot].astype(np.int64)
                    key_hi = hrep.astype(np.int64) * radix + hi_tok
                    hit = np.isin(key_lo, key_hi)
                    c0, _ = dup_cols[j][i]
                    rr = occ2[rep[hit]]
                    ss = slot[hit]
                    np.bitwise_or.at(
                        wide_u,
                        (rr, c0 + (ss >> 5)),
                        np.uint32(1) << (ss & 31).astype(np.uint32),
                    )
                parts[j] = wide
            if R > 4:
                for j in range(nt):
                    if parts[j].shape[1] < R:
                        pad = np.zeros((parts[j].shape[0], R), np.int32)
                        pad[:, : parts[j].shape[1]] = parts[j]
                        parts[j] = pad
            cached = self._combined_cache = (
                np.concatenate(parts, 0),
                np.concatenate(ctoks, 0),
                np.concatenate(clps, 0),
                row_offs,
                child_offs,
                s_list,
                dup_cols,
            )
        return cached

    def _combined_device(self):
        """The device half of :meth:`_combined_tables`: the stacked rows,
        the children and the per-slot constants of the query."""
        if self._combined_dev is None:
            dense_all, ctok_all, clp_all, row_offs, child_offs, s_list, dup_cols = (
                self._combined_tables()
            )
            dev = self.device
            slot_order = np.concatenate(
                [np.full((s,), i, np.int64) for i, s in enumerate(s_list)]
            )  # which order each child slot belongs to
            local_off = np.concatenate(
                [np.arange(s, dtype=np.int64) for s in s_list]
            )  # slot index within its order's span
            wsels = {}
            for j in range(1, len(s_list)):
                wsel = np.full((local_off.shape[0],), -1, np.int64)
                for i in range(j):
                    blk = slot_order == i
                    wsel[blk] = dup_cols[j][i][0] + (local_off[blk] >> 5)
                if (wsel >= 0).any():
                    wsels[j] = torch.as_tensor(wsel, device=dev)
            self._combined_dev = dict(
                dense=torch.as_tensor(dense_all, device=dev),
                ctok=torch.as_tensor(ctok_all, device=dev),
                clp=torch.as_tensor(clp_all, device=dev),
                row_offs=row_offs,
                child_offs=child_offs,
                s_list=s_list,
                slot_order=torch.as_tensor(slot_order, device=dev),
                local_off=torch.as_tensor(local_off, device=dev),
                shift=torch.as_tensor((local_off & 31).astype(np.int32), device=dev),
                wsels=wsels,
            )
        return self._combined_dev

    def sparse_corrections(self, ctx, want_logz: bool = True):
        """Backoff-LM log-probs as ``uni[v] + base`` plus sparse overrides.

        For query contexts ``ctx`` (``(N - 1, *B)`` token ids, most recent
        first) the conditional log-prob of every token ``v`` is ``uni[v] +
        base`` unless ``v`` matches a stored higher-order n-gram, where it
        is ``vals[c]`` for the ``c`` with ``toks[c] == v`` (the highest
        matching order wins). Returns ``(base (*B,), toks (*B, C), vals
        (*B, C), valid (*B, C), logZ (*B,))``, ``C = max_corrections``;
        ``logZ`` is the exact log-normalizer of the context's full
        distribution."""
        return self.sparse_corrections_ext(ctx, want_logz)[:5]

    def sparse_corrections_ext(self, ctx, want_logz: bool = True):
        """:meth:`sparse_corrections` plus ``logb (*B, N - 1)``, each found
        context order's backoff weight, and ``bounds``, the static slot
        ranges of each order in the correction axis. ``ctx`` is ``(N - 1,
        *B)`` or a list of ``N - 1`` per-order ``(*B,)`` tensors (most
        recent first); every output keeps the batch dims."""
        N = self.max_ngram
        if N == 1:
            raise RuntimeError("sparse_corrections requires max_ngram > 1")
        if isinstance(ctx, (list, tuple)):
            if len(ctx) != N - 1:
                raise RuntimeError(
                    f"expected {N - 1} per-order context arrays, got {len(ctx)}"
                )
            ctx = torch.stack([torch.as_tensor(c) for c in ctx], 0)
        ctx = torch.as_tensor(ctx, device=self.device).long()
        bshape = ctx.shape[1:]
        flat = ctx.reshape(N - 1, -1)
        if self._combined_tables() is not None:
            out = self._sparse_dense(flat, want_logz)
        else:
            out = self._sparse_probing(flat, want_logz)

        def rs(a):
            return None if a is None else a.reshape(bshape + a.shape[1:])

        return tuple(rs(a) for a in out[:6]) + (out[6],)

    def _sparse_dense(self, q: torch.Tensor, want_logz: bool):
        """The combined dense tables: one row gather per order, one child
        gather, the shadow bits; the stored normalizer."""
        c = self._combined_device()
        N = self.max_ngram
        B = q.shape[1]
        base_ix = self._ctx_tables[0].base
        E = c["clp"].shape[0]
        idx = okc = None
        rows_l, okc_l = [], []
        for i in range(N - 1):
            qi = q[i]
            oki = (qi >= 0) & (qi < base_ix)
            okc = oki if okc is None else (okc & oki)
            # order-(i + 1) row: sum_k ctx[k] * base**k over the i + 1 most
            # recent tokens
            t = qi.clamp(0, base_ix - 1) * base_ix**i
            idx = t if idx is None else idx + t
            rows_l.append(c["dense"][idx + c["row_offs"][i]])
            okc_l.append(okc)
        logb_l, start_l, len_l, present_l = [], [], [], []
        logZ = torch.full(
            (B,), float(np.log(max(self._sum_u, 1e-300))),
            dtype=torch.float32, device=q.device,
        )
        for i in range(N - 1):
            rows_i, okc = rows_l[i], okc_l[i]
            # out-of-range context tokens read as not found
            len_i = torch.where(okc, rows_i[:, 2], 0)
            logb_i = torch.where(okc, _as_f32(rows_i[:, 0]), 0.0)
            logb_l.append(logb_i)
            start_l.append(rows_i[:, 1])
            len_l.append(len_i)
            present = okc & ((len_i > 0) | (logb_i != 0.0))
            # the highest present order's stored normalizer wins
            logZ = torch.where(present, _as_f32(rows_i[:, 3]), logZ)
        base = logb_l[0]
        for i in range(1, N - 1):
            base = base + logb_l[i]
        slot_order = c["slot_order"]

        def spread(per_order):
            # (B,) per order -> (B, C): each order's value over its slots
            out = per_order[0][:, None]
            for i in range(1, N - 1):
                out = torch.where(slot_order >= i, per_order[i][:, None], out)
            return out

        # value of an order-n match = stored logp + backoffs of all the
        # higher orders escaped through (summed in increasing order)
        sfx_l = []
        for i in range(N - 1):
            s = None
            for j in range(i + 1, N - 1):
                s = logb_l[j] if s is None else (s + logb_l[j])
            sfx_l.append(torch.zeros_like(base) if s is None else s)
        local_off = c["local_off"]
        pos = (
            spread([start_l[i].long() + c["child_offs"][i] for i in range(N - 1)])
            + local_off
        ).clamp(0, E - 1)
        toks = c["ctok"][pos]
        val = c["clp"][pos] + spread(sfx_l)
        valid = local_off < spread(len_l)
        # higher-order matches override lower ones: the shadow bits baked
        # into the higher orders' rows
        for j, wsel in c["wsels"].items():
            acc = torch.gather(rows_l[j], 1, wsel.clamp_min(0)[None].expand(B, -1))
            d = (((acc >> c["shift"]) & 1) != 0) & (wsel >= 0) & okc_l[j][:, None]
            valid = valid & ~d
        bounds = np.concatenate([[0], np.cumsum(c["s_list"])])
        logb_all = torch.stack(logb_l, -1)
        return base, toks, val, valid, logZ if want_logz else None, logb_all, bounds

    def _sparse_probing(self, ctx: torch.Tensor, want_logz: bool):
        """The hash-probing fallback: per-order child lists, compared
        against each other for shadowing; the normalizer from the lists."""
        N = self.max_ngram
        logbs, tokss, lpss, valids, uniss = [], [], [], [], []
        for n in range(2, N + 1):
            ctx_n = ctx[: n - 1].flip(0).T  # (B, n - 1), earliest first
            f, lb, tk, lp, vd, un = self._ctx_tables[n - 2].probe_children(ctx_n)
            logbs.append(torch.where(f, lb, 0.0))
            tokss.append(tk)
            lpss.append(lp)
            valids.append(vd)
            uniss.append(un)
        base = sum(logbs)
        vals = []
        for i in range(len(lpss)):
            if i + 1 < len(logbs):
                vals.append(lpss[i] + sum(logbs[i + 1:])[:, None])
            else:
                vals.append(lpss[i] + 0.0)
        for i in range(len(tokss)):
            for j in range(i + 1, len(tokss)):
                dup = (
                    (tokss[i][:, :, None] == tokss[j][:, None, :])
                    & valids[j][:, None, :]
                ).any(2)
                valids[i] = valids[i] & ~dup
        toks = torch.cat(tokss, 1)
        val = torch.cat(vals, 1)
        valid = torch.cat(valids, 1)
        logb_all = torch.stack(logbs, 1)
        bounds = np.concatenate([[0], np.cumsum([t.shape[1] for t in tokss])])
        if not want_logz:
            return base, toks, val, valid, None, logb_all, bounds
        # exact normalizer: the all-backoff mass, with corrected tokens'
        # unigram mass swapped for their stored mass
        if all(u is not None for u in uniss):
            uni_at = torch.cat(uniss, 1)
        else:
            uni_at = self._uni_t[toks.long().clamp(0, self.vocab_size - 1)]
        covered = torch.where(valid, torch.exp(uni_at), 0.0).sum(1)
        zb = (self._sum_u - covered).clamp_min(0.0) * torch.exp(base)
        z = zb + torch.where(valid, torch.exp(val), 0.0).sum(1)
        return base, toks, val, valid, torch.log(z), logb_all, bounds

    _DENSE_NGRAM_MAX = 1 << 23

    def order2_values(self) -> Optional[np.ndarray]:
        """Direct-indexed bigram log-probs: flat ``(base * V,)`` float32
        with ``arr[c * V + v] = logp(v | c)`` and ``+inf`` marking absent
        pairs; None when it would exceed ``_DENSE_NGRAM_MAX`` entries or
        no bigrams exist."""
        if self.max_ngram < 2:
            return None
        if self._order2_cache is not None:
            return self._order2_cache
        t = self._ctx_tables[0]
        V = self.vocab_size
        if t.base <= 0 or t.base * V > self._DENSE_NGRAM_MAX:
            return None
        arr = np.full((t.base * V,), np.inf, np.float32)
        occupied = np.nonzero(t.keys[:, 0] != _EMPTY_KEY)[0]
        for slot in occupied:
            c = int(t.keys[slot, 0])
            start, length = (int(x) for x in t.ivals[slot])
            toks = t.child_tok[start:start + length].astype(np.int64)
            arr[c * V + toks] = t.child_logp[start:start + length]
        self._order2_cache = arr
        return arr

    def _order2_table(self) -> Optional[torch.Tensor]:
        """:meth:`order2_values` on the LM's device, copied there once."""
        if self._order2_dev is None:
            arr = self.order2_values()
            if arr is None:
                return None
            self._order2_dev = torch.as_tensor(arr, device=self.device)
        return self._order2_dev

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        """The host arrays of the tables, under the JAX package's keys."""
        d = {
            "uni_logp": self._uni_logp,
            "meta": np.asarray([self.vocab_size, self.sos, self.max_ngram]),
        }
        for i, t in enumerate(self._ctx_tables):
            d[f"ctx{i}_keys"] = t.keys
            d[f"ctx{i}_fvals"] = t.fvals
            d[f"ctx{i}_ivals"] = t.ivals
            d[f"ctx{i}_tok"] = t.child_tok
            d[f"ctx{i}_logp"] = t.child_logp
            d[f"ctx{i}_meta"] = np.asarray([t.max_probe, t.max_children])
            if getattr(t, "logz_slot", None) is not None:
                d[f"ctx{i}_logz"] = t.logz_slot
        return d

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        """Load a state dict of this package's or the JAX package's
        :meth:`state_dict` (numpy arrays, or tensors); one saved before
        stored normalizers gets them recomputed once, with a warning."""
        d = {
            k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in d.items()
        }
        self.vocab_size, self.sos, self.max_ngram = (int(x) for x in d["meta"])
        self._uni_logp = np.asarray(d["uni_logp"], np.float32)
        self._sum_u = float(np.exp(self._uni_logp[np.isfinite(self._uni_logp)]).sum())

        def load(i):
            t = _CtxTable.__new__(_CtxTable)
            t.device = self.device
            t.keys = np.asarray(d[f"ctx{i}_keys"], np.int32)
            t.fvals = np.asarray(d[f"ctx{i}_fvals"], np.float32)
            t.ivals = np.asarray(d[f"ctx{i}_ivals"], np.int32)
            t.child_tok = np.asarray(d[f"ctx{i}_tok"], np.int32)
            t.child_logp = np.asarray(d[f"ctx{i}_logp"], np.float32)
            t.size, t.n = t.keys.shape
            t.max_probe = int(d[f"ctx{i}_meta"][0])
            t.max_children = int(d[f"ctx{i}_meta"][1])
            t.base = (max(self.vocab_size, self.sos) + 1) if self.sos >= 0 else 0
            t.uni = self._uni_logp
            if f"ctx{i}_logz" in d:
                t.logz_slot = np.asarray(d[f"ctx{i}_logz"], np.float32)
            t._pack()
            return t

        self._ctx_tables = [load(i) for i in range(self.max_ngram - 1)]
        if self.max_ngram > 1 and any(
            getattr(t, "logz_slot", None) is None for t in self._ctx_tables
        ):
            warnings.warn(
                "LookupLanguageModel state dict predates stored "
                "normalizers; recomputing exact logZ tables (one-time, "
                "host-side). Re-save with state_dict() to skip this."
            )
            kid_maps, logb_maps = [], []
            for t in self._ctx_tables:
                kids, logbs = {}, {}
                for slot in np.nonzero(t.keys[:, 0] != _EMPTY_KEY)[0]:
                    ctx = tuple(int(x) for x in t.keys[slot])
                    start, length = (int(x) for x in t.ivals[slot])
                    logbs[ctx] = float(t.fvals[slot])
                    if length:
                        kids[ctx] = [
                            (int(t.child_tok[start + j]), float(t.child_logp[start + j]))
                            for j in range(length)
                        ]
                kid_maps.append(kids)
                logb_maps.append(logbs)
            self._store_logzs(kid_maps, logb_maps)
        self._reset_caches()

    def score_sequences(self, hist) -> torch.Tensor:
        """Per-token conditional log-probs ``(S, N)`` of given sequences:
        ``calc_full_log_probs(hist)[t, n, hist[t, n]]``, probing only the
        observed token at each position. Ids outside ``[0, V)`` score
        ``-inf``."""
        hist = torch.as_tensor(hist, device=self.device)
        if hist.dim() != 2:
            raise RuntimeError("hist must be 2 dimensional")
        S, N = hist.shape
        V = self.vocab_size
        bad = ((hist < 0) | (hist >= V)).reshape(-1)
        tok = hist.long().clamp(0, V - 1).reshape(-1)
        uni_at_tok = self._uni_t[tok]
        if self.max_ngram == 1 or S == 0:
            return torch.where(bad, -float("inf"), uni_at_tok).reshape(S, N)
        # contexts of every position at once: ctx[j, t, n] = hist[t-1-j, n]
        Ngm1 = self.max_ngram - 1
        pos = (
            torch.arange(S, device=self.device)[None, :] - 1
            - torch.arange(Ngm1, device=self.device)[:, None]
        )
        gathered = hist[pos.clamp(0, S - 1)]  # (Ng - 1, S, N)
        ctx = torch.where((pos >= 0)[..., None], gathered.long(), self.sos)
        ctx = ctx.reshape(Ngm1, S * N)
        if self.max_corrections > config.SPARSE_FUSION_MAX_CORRECTIONS:
            # wide correction lists: the dense row of each position, a
            # bounded chunk at a time, and the one token gathered
            chunk = max(1, 4096 // max(V, 1)) * 8
            parts = []
            for c0 in range(0, S * N, chunk):
                lp = self._log_probs_at(ctx[:, c0 : c0 + chunk])
                parts.append(lp.gather(1, tok[c0 : c0 + chunk, None])[:, 0])
            out = torch.cat(parts)
        else:
            base, ctoks, cvals, cvalid, _ = self.sparse_corrections(ctx, want_logz=False)
            match = (ctoks.long() == tok[:, None]) & cvalid
            out = torch.where(match, cvals, 0.0).sum(1) + torch.where(
                match.any(1), 0.0, base + uni_at_tok
            )
        return torch.where(bad, -float("inf"), out).reshape(S, N)
