"""Serving artifacts: export a recognizer once, save it, serve it without
the model code (counterpart of :mod:`pydrobert_tpu.export`).

The JAX package serializes StableHLO with :mod:`jax.export`; here the
program is traced by :func:`torch.export.export` and saved with
:func:`torch.export.save`. An **artifact** is a directory:

- ``meta.json``      — schema version, entry name, target platforms, the
                       input signature of each specialization, the paddable
                       axes, the output batch axis, ``extra`` and, for a
                       mesh artifact, the mesh and its partition specs (the
                       JAX schema, with ``"cuda"`` for ``"tpu"``);
- ``params.npz``     — the parameters flattened by ``/``-joined path
                       (:func:`flatten_arrays`), passed to the program at
                       each call as the JAX package's are;
- ``<entry>_<k>.pt2`` — one exported program for each input-shape
                       specialization. Shapes are static; the loader picks
                       the smallest specialization that fits a call and
                       zero-pads up to it.

Loading needs no model code: :meth:`ServingArtifact.load` imports only
:mod:`pydrobert_tpu_torch.ops.kernels`, which registers the kernels'
operators. Every program records them (a wrapper traced by
:func:`torch.export.export` records its operator on any device), and each
operator runs its plain version on a CPU tensor and launches its kernel on
a CUDA one. So an artifact runs on ``("cpu", "cuda")`` wherever it was
exported: the loader moves the program to its device, and on the card it
launches the kernels. The JAX package's ``allow_pallas`` has no
counterpart, because a Pallas TPU kernel has no CPU lowering and these
operators have one.

The searches' frame loops are exported as one ``scan`` each
(:func:`~pydrobert_tpu_torch.ops._loops.frame_loop`), not unrolled, and read
nothing on the host while traced. :func:`export_ctc_recognizer` and
:func:`export_transducer_recognizer` build the serving heads;
:func:`ctc_recognizer` is the eager callable the CTC artifact holds.
"""

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import default_device

__all__ = [
    "ServingArtifact",
    "ctc_recognizer",
    "export_ctc_recognizer",
    "export_transducer_recognizer",
    "flatten_arrays",
    "unflatten_arrays",
]

_META_NAME = "meta.json"
_PARAMS_NAME = "params.npz"
_VERSION = 1


def _flatten_dict(tree: Dict[str, Any], _prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        key = str(key)
        if "/" in key:
            raise ValueError(f"key {key!r} contains '/'")
        path = _prefix + key
        if isinstance(val, dict):
            out.update(_flatten_dict(val, path + "/"))
        else:
            out[path] = val
    return out


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if hasattr(v, "full_tensor"):  # a DTensor
            v = v.full_tensor()
        return v.detach().cpu().numpy()
    return np.asarray(v)


def flatten_arrays(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Flatten a nested dict of arrays or tensors into ``{'a/b/c': array}``
    (numpy). The inverse of :func:`unflatten_arrays`. Keys must not contain
    ``/``; a state dict's dotted names stay as they are."""
    return {k: _to_numpy(v) for k, v in _flatten_dict(tree).items()}


def unflatten_arrays(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Rebuild the nested dict flattened by :func:`flatten_arrays`. A JAX
    package artifact's ``params.npz`` so becomes the flax tree that the
    models' ``state_dict_from_jax`` take."""
    out: Dict[str, Any] = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return out


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _sig_entry(x: torch.Tensor) -> Dict[str, Any]:
    return {"shape": list(x.shape), "dtype": _dtype_name(x.dtype)}


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _spec_to_json(spec) -> List[Any]:
    return [None if e is None else (e if isinstance(e, str) else list(e)) for e in spec]


class _Entry(torch.nn.Module):
    """The traced module: ``fn(params, *inputs)``."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, params, *inputs):
        return self.fn(params, *inputs)


class ServingArtifact:
    """A loaded serving artifact: ``artifact(*inputs)`` runs the program.

    Call inputs (tensors or arrays) are matched against the exported
    specializations by shape and dtype; when none matches exactly, each
    paddable axis recorded at export is zero-padded up to the smallest
    specialization that fits, and batch-major outputs are sliced back to
    the caller's batch. A call no specialization fits raises
    ``ValueError``. Outputs are tensors on the artifact's device.
    """

    def __init__(
        self,
        meta: Dict[str, Any],
        params: Dict[str, Any],
        programs: List[Any],
        device=None,
    ):
        self.meta = meta
        self.params = params
        self._programs = programs
        self.device = default_device(device)
        self._compiled: Dict[int, Callable] = {}
        self._mesh = None

    # -- construction -------------------------------------------------

    @staticmethod
    def export(
        path: str,
        fn: Callable,
        params: Dict[str, Any],
        specs: Sequence[Tuple],
        *,
        entry: str = "recognize",
        platforms: Sequence[str] = ("cpu", "cuda"),
        paddable: Optional[Sequence[Sequence[int]]] = None,
        output_batch_axis: Optional[int] = 0,
        extra_meta: Optional[Dict[str, Any]] = None,
        mesh=None,
        param_specs: Optional[Dict[str, Any]] = None,
        input_specs: Optional[Sequence[Any]] = None,
    ) -> "ServingArtifact":
        """Trace ``fn(params, *inputs)`` at every spec and write ``path``.

        ``params`` is a dict (nested or a state dict) of tensors on the
        device the trace runs on; ``specs`` a sequence of example input
        tuples (their shapes and dtypes count, not their values).
        ``paddable``, when given, lists for each input the axes the loader
        may zero-pad to reach a larger specialization; ``output_batch_axis``
        (or None) tells it which output axis to slice back. ``platforms``
        are the devices :meth:`load` accepts.

        **Mesh artifacts**: pass ``mesh`` (:func:`~pydrobert_tpu_torch.
        parallel.make_mesh`) with ``param_specs`` (a dict of
        :class:`~pydrobert_tpu_torch.parallel.PartitionSpec` congruent with
        ``params``, as :func:`~pydrobert_tpu_torch.parallel.
        param_partition_specs` gives) and ``input_specs`` (one spec per
        input; the batch axis may shard over ``data``). A mesh artifact here
        is data-parallel with replicated parameters: the program is traced
        at one rank's rows of the batch, and the loader rebuilds the mesh
        over the serving group's ranks, runs each rank's rows with the full
        parameters and gathers the outputs over the ``data`` axis. The
        parameter specs are kept in ``meta.json`` for the JAX schema and
        do not change what a rank holds or computes; XLA instead shards the
        parameters and bakes the collectives into its module.
        """
        platforms = tuple(platforms)
        if not specs:
            raise ValueError("need at least one input specialization")
        rows = 1
        if mesh is not None:
            if param_specs is None or input_specs is None:
                raise ValueError("mesh exports need param_specs and input_specs")
            rows = _data_extent(mesh, input_specs)
        flat = _flatten_dict(params)
        full = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v) for k, v in flat.items()}
        dev = next(iter(full.values())).device if full else torch.device("cpu")
        traced = unflatten_arrays(full) if full.keys() != params.keys() else full
        programs, sigs = [], []
        for spec in specs:
            spec = tuple(_as_tensor(x) for x in spec)
            sigs.append([_sig_entry(x) for x in spec])
            local = []
            for i, x in enumerate(spec):
                x = torch.zeros_like(x, device=dev)
                if rows > 1 and _shards_batch(input_specs[i]):
                    if x.shape[0] % rows:
                        raise ValueError(
                            f"spec batch {x.shape[0]} does not divide over {rows} data ranks"
                        )
                    x = x[: x.shape[0] // rows]
                local.append(x)
            with torch.no_grad():
                ep = torch.export.export(_Entry(fn), (traced, *local), strict=False)
            # the example inputs hold the parameters: params.npz keeps them
            # once, not again in every program
            ep.example_inputs = None
            programs.append(ep)
        meta: Dict[str, Any] = {
            "version": _VERSION,
            "entry": entry,
            "platforms": list(platforms),
            "specs": sigs,
            "paddable": list(map(list, paddable)) if paddable is not None else None,
            "output_batch_axis": output_batch_axis,
            "export_device": dev.type,
        }
        if mesh is not None:
            meta["mesh"] = {
                "axis_names": list(mesh.mesh_dim_names),
                "shape": [int(s) for s in mesh.mesh.shape],
            }
            meta["param_specs"] = {
                k: _spec_to_json(v) for k, v in _flatten_dict(param_specs).items()
            }
            meta["input_specs"] = [_spec_to_json(s) for s in input_specs]
        if extra_meta:
            meta["extra"] = extra_meta
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _META_NAME), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
        np.savez(os.path.join(path, _PARAMS_NAME), **flatten_arrays(full))
        for k, ep in enumerate(programs):
            torch.export.save(ep, os.path.join(path, f"{entry}_{k}.pt2"))
        return ServingArtifact(meta, traced, programs, dev)

    @staticmethod
    def load(path: str, device=None) -> "ServingArtifact":
        """Read an artifact directory onto ``device`` (``cuda`` unless a
        CPU device is passed). No model code is needed: this imports only
        :mod:`pydrobert_tpu_torch.ops.kernels`, whose import registers the
        kernels' operators that the programs call."""
        from .ops import kernels  # noqa: F401  (registers the operators)

        with open(os.path.join(path, _META_NAME)) as f:
            meta = json.load(f)
        if meta.get("version") != _VERSION:
            raise ValueError(f"artifact version {meta.get('version')} != {_VERSION}")
        device = default_device(device)
        plat = "cuda" if device.type == "cuda" else "cpu"
        if plat not in meta["platforms"]:
            raise ValueError(
                f"artifact was exported for {meta['platforms']}, not {plat!r}"
            )
        with np.load(os.path.join(path, _PARAMS_NAME)) as z:
            flat = {k: torch.from_numpy(z[k].copy()).to(device) for k in z.files}
        params = unflatten_arrays(flat) if any("/" in k for k in flat) else flat
        programs = [
            torch.export.load(os.path.join(path, f"{meta['entry']}_{k}.pt2"))
            for k in range(len(meta["specs"]))
        ]
        return ServingArtifact(meta, params, programs, device)

    # -- dispatch ------------------------------------------------------

    def _fits(self, sig: List[Dict[str, Any]], inputs: Sequence) -> bool:
        """Exact dtype match; shapes equal or paddable up to the sig."""
        paddable = self.meta.get("paddable")
        for i, (entry, x) in enumerate(zip(sig, inputs)):
            x = _as_tensor(x)
            if _dtype_name(x.dtype) != entry["dtype"]:
                return False
            want, have = entry["shape"], list(x.shape)
            if len(want) != len(have):
                return False
            axes = set(paddable[i]) if paddable is not None else set()
            for ax, (w, h) in enumerate(zip(want, have)):
                if h == w or (h < w and ax in axes):
                    continue
                return False
        return True

    def _cost(self, sig: List[Dict[str, Any]]) -> int:
        return int(sum(int(np.prod(entry["shape"])) for entry in sig))

    def _ensure_mesh(self):
        """(Re)build the export-time mesh over this group's ranks."""
        if self._mesh is None:
            from .parallel.mesh import host_shard_info, mesh_over

            info = self.meta["mesh"]
            shape = tuple(info["shape"])
            n = int(np.prod(shape))
            _, world = host_shard_info()
            if world < n:
                raise RuntimeError(
                    f"artifact was exported for a {shape} mesh ({n} ranks); "
                    f"this group has {world}"
                )
            self._mesh = mesh_over(shape, tuple(info["axis_names"]), self.device.type)
        return self._mesh

    def _call_k(self, k: int) -> Callable:
        fn = self._compiled.get(k)
        if fn is None:
            ep = self._programs[k]
            if self.meta.get("export_device", self.device.type) != self.device.type:
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, str(self.device))
            fn = self._compiled[k] = ep.module()
        return fn

    def __call__(self, *inputs):
        if len(inputs) != len(self.meta["specs"][0]):
            raise TypeError(
                f"expected {len(self.meta['specs'][0])} inputs, got {len(inputs)}"
            )
        candidates = [
            k for k, sig in enumerate(self.meta["specs"]) if self._fits(sig, inputs)
        ]
        if not candidates:
            avail = [[tuple(e["shape"]) for e in sig] for sig in self.meta["specs"]]
            raise ValueError(
                f"no exported specialization fits input shapes "
                f"{[tuple(_as_tensor(x).shape) for x in inputs]}; available: {avail}"
            )
        k = min(candidates, key=lambda k: self._cost(self.meta["specs"][k]))
        sig = self.meta["specs"][k]
        batch_in = int(_as_tensor(inputs[0]).shape[0]) if _as_tensor(inputs[0]).dim() else 0
        padded = []
        for entry, x in zip(sig, inputs):
            x = _as_tensor(x).to(self.device)
            pads = []
            for w, h in reversed(list(zip(entry["shape"], x.shape))):
                pads += [0, w - h]
            if any(pads):
                x = torch.nn.functional.pad(x, pads)
            padded.append(x)
        bax = self.meta.get("output_batch_axis")
        with torch.no_grad():
            if self.meta.get("mesh"):
                out = self._call_mesh(k, padded, bax)
            else:
                out = self._call_k(k)(self.params, *padded)
        if bax is None or batch_in == sig[0]["shape"][0]:
            return out

        def _slice(y):
            if isinstance(y, torch.Tensor) and y.dim() > bax and y.shape[bax] == sig[0]["shape"][0]:
                return y.narrow(bax, 0, batch_in)
            return y

        return type(out)(_slice(y) for y in out) if isinstance(out, (tuple, list)) else _slice(out)

    def _call_mesh(self, k: int, padded: List[torch.Tensor], bax: Optional[int]):
        """One rank's rows through the program with the full (replicated)
        parameters, the outputs gathered over the ``data`` axis."""
        from .parallel.mesh import DATA_AXIS

        mesh = self._ensure_mesh()
        names = list(mesh.mesh_dim_names)
        dp = mesh.size(names.index(DATA_AXIS)) if DATA_AXIS in names else 1
        d = mesh.get_local_rank(DATA_AXIS) if dp > 1 else 0
        local = []
        for x, spec in zip(padded, self.meta["input_specs"]):
            if dp > 1 and _shards_batch(spec):
                n = x.shape[0] // dp
                x = x[d * n : (d + 1) * n]
            local.append(x)
        out = self._call_k(k)(self.params, *local)
        if dp == 1 or bax is None:
            return out
        group = mesh.get_group(DATA_AXIS)
        seq = out if isinstance(out, (tuple, list)) else (out,)
        gathered = []
        for y in seq:
            parts = [torch.empty_like(y) for _ in range(dp)]
            torch.distributed.all_gather(parts, y.contiguous(), group=group)
            gathered.append(torch.cat(parts, bax))
        return type(out)(gathered) if isinstance(out, (tuple, list)) else gathered[0]


def _shards_batch(spec) -> bool:
    from .parallel.mesh import DATA_AXIS

    if not spec:
        return False
    first = spec[0]
    return first == DATA_AXIS or (isinstance(first, (tuple, list)) and DATA_AXIS in first)


def _data_extent(mesh, input_specs) -> int:
    from .parallel.mesh import DATA_AXIS

    names = list(mesh.mesh_dim_names)
    if DATA_AXIS not in names or not any(_shards_batch(s) for s in input_specs):
        return 1
    return int(mesh.size(names.index(DATA_AXIS)))


def _mesh_kwargs(mesh, partition_rules: Optional[Callable], params) -> Dict[str, Any]:
    """Mesh and sharding keywords for :meth:`ServingArtifact.export`: the
    batch inputs (feats, lens) shard over the ``data`` axis, the parameters
    take ``partition_rules`` with the divisibility fallback."""
    if mesh is None:
        return {}
    if partition_rules is None:
        raise ValueError("mesh exports need partition_rules")
    from .parallel.mesh import DATA_AXIS, PartitionSpec, param_partition_specs

    return {
        "mesh": mesh,
        "param_specs": param_partition_specs(params, mesh, partition_rules),
        "input_specs": [PartitionSpec(DATA_AXIS), PartitionSpec(DATA_AXIS)],
    }


class _Method(torch.nn.Module):
    """``model.<method>(*inputs, *args)`` as a module's forward, so that
    :func:`torch.func.functional_call` can run it with given parameters."""

    def __init__(self, model: torch.nn.Module, method: str, args: Tuple):
        super().__init__()
        self.model = model
        self.method = method
        self.args = args

    def forward(self, *inputs):
        return getattr(self.model, self.method)(*inputs, *self.args)


def _head_params(model, params) -> Dict[str, torch.Tensor]:
    return dict(model.state_dict()) if params is None else dict(params)


def ctc_recognizer(
    model: torch.nn.Module,
    width: Optional[int] = None,
    beta: float = 0.2,
    lm=None,
) -> Callable:
    """``recognize(feats (N, T, F), lens (N,))`` on ``model``'s device.

    With ``width`` None the head is greedy and returns ``(hyps (N, S),
    lens (N,))``; otherwise a width-``width`` CTC prefix search returns
    ``(hyps (N, W, S), lens (N, W), probs (N, W))``, beams in descending
    order of probability. ``model`` maps ``(feats, lens)`` to batch-major
    ``(logits (N, T', V + 1), out_lens)`` with the blank last, as
    :class:`pydrobert_tpu_torch.models.ConformerCTC` does. The search is
    shallow-fused with ``lm`` at weight ``beta``, as the JAX package's
    ``export_ctc_recognizer`` does; a
    :class:`~pydrobert_tpu_torch.lm.LookupLanguageModel` must live on the
    model's device. :func:`export_ctc_recognizer` saves this head as an
    artifact.
    """
    from .ops.decoding import CTCPrefixSearch, ctc_greedy_search

    if width is None:

        @torch.no_grad()
        def recognize(feats, lens):
            logits, out_lens = model(feats, lens)
            _, hyps, hyp_lens = ctc_greedy_search(
                logits, out_lens, batch_first=True
            )
            return hyps, hyp_lens

    else:
        search = CTCPrefixSearch(width, beta=beta, lm=lm)

        @torch.no_grad()
        def recognize(feats, lens):
            logits, out_lens = model(feats, lens)
            y, y_lens, y_probs = search(
                logits.transpose(0, 1).contiguous(), out_lens
            )
            # (S, N, W) -> batch-major (N, W, S)
            return y.permute(1, 2, 0), y_lens, y_probs

    return recognize


def export_ctc_recognizer(
    path: str,
    model: torch.nn.Module,
    params: Optional[Dict[str, torch.Tensor]] = None,
    *,
    specs: Sequence[Tuple[int, int]],
    width: Optional[int] = None,
    lm=None,
    beta: float = 0.2,
    platforms: Sequence[str] = ("cpu", "cuda"),
    mesh=None,
    partition_rules: Optional[Callable] = None,
) -> ServingArtifact:
    """Export a CTC serving head, ``artifact(feats, lens)``:
    :func:`ctc_recognizer`'s outputs, batch-major.

    ``specs`` lists ``(batch, max_frames)`` specializations of float32
    ``feats (batch, max_frames, num_filts)`` and int32 ``lens (batch,)``.
    ``params`` (the model's ``state_dict()`` when None) are the weights
    saved and passed to the program. A width-``width`` program records the
    decode prologue's operator, or on the whole-loop route
    (``config.USE_BEAM_KERNEL``) ``top_m``'s and ``ctc_beam_search``'s, and
    launches those kernels when it is served on the card. Passing
    ``mesh`` and ``partition_rules`` (for example
    :func:`~pydrobert_tpu_torch.models.conformer_partition_rules`) exports
    a mesh artifact (see :meth:`ServingArtifact.export`).
    """
    from .ops.decoding import CTCPrefixSearch, ctc_greedy_search

    params = _head_params(model, params)
    mesh_kw = _mesh_kwargs(mesh, partition_rules, params)
    num_filts = model.cfg.num_filts
    if width is None:

        def fn(params, feats, lens):
            logits, out_lens = torch.func.functional_call(model, params, (feats, lens))
            _, hyps, hyp_lens = ctc_greedy_search(logits, out_lens, batch_first=True)
            return hyps, hyp_lens

    else:
        search = CTCPrefixSearch(width, beta=beta, lm=lm)

        def fn(params, feats, lens):
            logits, out_lens = torch.func.functional_call(model, params, (feats, lens))
            y, y_lens, y_probs = search(logits.transpose(0, 1).contiguous(), out_lens)
            return y.permute(1, 2, 0), y_lens, y_probs

    arg_specs = [
        (torch.zeros((n, t, num_filts)), torch.zeros((n,), dtype=torch.int32))
        for n, t in specs
    ]
    return ServingArtifact.export(
        path, fn, params, arg_specs,
        entry="ctc_recognize",
        platforms=platforms,
        paddable=[(0, 1), (0,)],
        output_batch_axis=0,
        **mesh_kw,
        extra_meta={
            "family": "ctc",
            "width": width,
            "beta": beta,
            "fused_lm": lm is not None,
            "num_filts": num_filts,
        },
    )


def export_transducer_recognizer(
    path: str,
    model: torch.nn.Module,
    params: Optional[Dict[str, torch.Tensor]] = None,
    *,
    specs: Sequence[Tuple[int, int]],
    mode: str = "greedy",
    width: int = 4,
    max_symbols_per_frame: int = 4,
    lm=None,
    lm_weight: float = 0.3,
    platforms: Sequence[str] = ("cpu", "cuda"),
    mesh=None,
    partition_rules: Optional[Callable] = None,
) -> ServingArtifact:
    """Export an RNN-T serving head, ``artifact(feats, lens)``, of a
    :class:`~pydrobert_tpu_torch.models.ConformerTransducer`.

    ``specs`` lists ``(batch, max_frames)`` specializations. ``mode`` is
    ``"greedy"`` (``hyps (N, U)``, ``lens (N,)``) or ``"beam"`` (``hyps
    (N, W, U)``, ``lens (N, W)``, ``scores (N, W)``, with an optional
    shallow-fusion ``lm``). The searches run no kernel. ``mesh`` and
    ``partition_rules`` (for example
    :func:`~pydrobert_tpu_torch.models.transducer_partition_rules`) export
    a mesh artifact, as :func:`export_ctc_recognizer` does.
    """
    if mode not in ("greedy", "beam"):
        raise ValueError(f"mode must be 'greedy' or 'beam', got {mode!r}")
    num_filts = model.cfg.encoder.num_filts
    params = _head_params(model, params)
    mesh_kw = _mesh_kwargs(mesh, partition_rules, params)
    if mode == "greedy":
        head = _Method(model, "greedy", (max_symbols_per_frame,))
    else:
        head = _Method(model, "beam", (width, max_symbols_per_frame, lm, lm_weight))

    def fn(params, feats, lens):
        named = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(head, named, (feats, lens))

    arg_specs = [
        (torch.zeros((n, t, num_filts)), torch.zeros((n,), dtype=torch.int32))
        for n, t in specs
    ]
    return ServingArtifact.export(
        path, fn, params, arg_specs,
        entry="rnnt_recognize",
        platforms=platforms,
        paddable=[(0, 1), (0,)],
        output_batch_axis=0,
        **mesh_kw,
        extra_meta={
            "family": "transducer",
            "mode": mode,
            "width": width,
            "fused_lm": lm is not None,
            "num_filts": num_filts,
        },
    )
