"""The port's ``parallel`` package and the models' pipeline and sharding
helpers against the JAX package's (``tests/test_pipeline.py`` and the
sharded cases of ``tests/test_export.py``, by name).

JAX runs one process over 8 virtual CPU devices; the port runs one
process a rank under gloo. ``tests/_torch_parallel_worker.py`` runs at
world sizes 2 and 4 (six processes, started together, 120 s each at most),
on inputs and JAX weights this module writes, and each rank writes JSON
that the tests hold against the JAX package: pipeline outputs within 1e-6
and gradients within 1e-5 (the JAX tests' bounds), the pipelined conformer
forward within 2e-5, the train steps' losses within rtol 1e-5 and updated
parameters within rtol 1e-4, atol 1e-5, hypotheses exactly."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parallel_worker as W
from pydrobert_tpu import export as jexport
from pydrobert_tpu import parallel as jpar
from pydrobert_tpu.models import conformer as jconf
from pydrobert_tpu.models import transducer as jtrans
from pydrobert_tpu_torch.models import conformer as pconf
from pydrobert_tpu_torch.models import transducer as ptrans

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")

WORKER = os.path.join(os.path.dirname(__file__), "_torch_parallel_worker.py")
CASES = [(w, pp, tp, m) for w, cases in W.PIPE_CASES.items() for pp, tp, m in cases]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_models():
    cfg = jconf.ConformerConfig(dtype=jnp.float32, **W.CTC)
    ctc = jconf.ConformerCTC(cfg)
    feats, lens, refs, ref_lens = W.ctc_batch()
    ctc_params = jax.tree.map(
        np.asarray, ctc.init(jax.random.PRNGKey(0), feats, lens)["params"]
    )
    rnnt = jtrans.ConformerTransducer(
        jtrans.TransducerConfig(encoder=cfg, pred_dim=12, joint_dim=12)
    )
    f, l, r, rl = W.rnnt_batch()
    rnnt_params = jax.tree.map(
        np.asarray, rnnt.init(jax.random.PRNGKey(1), f, l, r, rl)["params"]
    )
    return ctc, ctc_params, rnnt, rnnt_params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both world sizes' workers, run together once; their JSON by rank."""
    ctc, ctc_params, rnnt, rnnt_params = _jax_models()
    flat = {f"ctc/{k}": v for k, v in jexport.flatten_arrays(ctc_params).items()}
    flat.update({f"rnnt/{k}": v for k, v in jexport.flatten_arrays(rnnt_params).items()})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    procs, dirs = [], {}
    for world in W.PIPE_CASES:
        d = tmp_path_factory.mktemp(f"world{world}")
        np.savez(d / "inputs.npz", **flat)
        dirs[world] = d
        port = _free_port()
        procs += [
            subprocess.Popen(
                [sys.executable, WORKER, str(r), str(world), str(port), str(d)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for r in range(world)
        ]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    out = {
        world: [json.load(open(d / f"rank{r}.json")) for r in range(world)]
        for world, d in dirs.items()
    }
    return out, (ctc, ctc_params, rnnt, rnnt_params)


def _jax_pipeline(pp, tp, m):
    mesh = jpar.make_pipeline_mesh(pp, tp)
    Ws, x, mask = W.toy(0, pp)

    def stage(Wt, h, mk):
        return jnp.tanh(h @ Wt) * mk[..., None]

    def run(Ws, x):
        return jpar.pipeline_apply(stage, Ws, x, extras=mask, mesh=mesh, n_microbatches=m)

    y = jax.jit(run)(Ws, x)
    gW, gx = jax.jit(jax.grad(lambda Ws, x: run(Ws, x).sum(), argnums=(0, 1)))(Ws, x)
    ref = x
    for i in range(pp):
        ref = stage(Ws[i], ref, mask)
    return np.asarray(y), np.asarray(gW), np.asarray(gx), np.asarray(ref)


@pytest.mark.parametrize("world,pp,tp,m", CASES)
def test_pipeline_apply_matches_sequential(runs, world, pp, tp, m):
    out, _ = runs
    y, _, _, ref = _jax_pipeline(pp, tp, m)
    np.testing.assert_allclose(y, ref, atol=1e-6)
    for rank in out[world]:
        np.testing.assert_allclose(np.asarray(rank["pipeline"][f"{pp},{tp},{m}"]["y"]), y, atol=1e-6)


@pytest.mark.parametrize("world,pp,tp,m", CASES)
def test_pipeline_apply_grad_matches_sequential(runs, world, pp, tp, m):
    """The hand-scheduled backward against ``jax.grad`` through the
    ``ppermute`` loop: the stage weights' and the input's gradients, the
    same on every rank."""
    out, _ = runs
    _, gW, gx, _ = _jax_pipeline(pp, tp, m)
    for rank in out[world]:
        case = rank["pipeline"][f"{pp},{tp},{m}"]
        np.testing.assert_allclose(np.asarray(case["gW"]), gW, atol=1e-5)
        np.testing.assert_allclose(np.asarray(case["gx"]), gx, atol=1e-5)


def test_stack_block_params_round_trip():
    ctc, params, _, _ = _jax_models()
    model = pconf.ConformerCTC(pconf.ConformerConfig(dtype=torch.float32, **W.CTC), device="cpu")
    model.load_state_dict(pconf.state_dict_from_jax(params), strict=True)
    sd = model.state_dict()
    pparams = pconf.stack_block_params(sd, 2)
    blocks = [k for k in pparams if k.startswith("blocks.")]
    assert blocks and all(pparams[k].shape[:2] == (2, 2) for k in blocks)
    assert not any(k.startswith("block_") for k in pparams)
    jp = jconf.stack_block_params(params, 2)
    # the same stacking as the JAX package's, in PyTorch's (out, in) layout
    np.testing.assert_array_equal(
        pparams["blocks.ffn1.wi.weight"].numpy(),
        np.swapaxes(np.asarray(jp["blocks"]["ffn1"]["wi"]["kernel"]), -1, -2),
    )
    back = pconf.unstack_block_params(pparams)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="not divisible"):
        pconf.stack_block_params(sd, 3)
    tp = ptrans.transducer_stack_block_params({"encoder.block_0.a": torch.ones(2),
                                                "encoder.block_1.a": torch.zeros(2),
                                                "joint.out.weight": torch.ones(1)}, 2)
    assert tp["encoder.blocks.a"].shape == (2, 1, 2) and "joint.out.weight" in tp
    assert ptrans.transducer_unstack_block_params(tp).keys() == {
        "encoder.block_0.a", "encoder.block_1.a", "joint.out.weight"}


def test_pipelined_forward_matches_model(runs):
    out, (ctc, params, _, _) = runs
    feats, lens = W.ctc_batch()[:2]
    mesh = jpar.make_pipeline_mesh(2, 2)
    pparams = jpar.shard_params(
        jconf.stack_block_params(params, 2), mesh, jconf.pipeline_partition_rules
    )
    fwd = jax.jit(jconf.make_pipelined_forward(ctc, mesh, n_microbatches=4))
    logits, out_lens = fwd(pparams, feats, lens)
    for rank in out[4]:
        np.testing.assert_array_equal(rank["conformer"]["out_lens"], np.asarray(out_lens))
        np.testing.assert_allclose(
            np.asarray(rank["conformer"]["logits"]), np.asarray(logits), atol=2e-5
        )


def _jax_step_params(model, params, make_step, stack, unstack, rules, batch, key):
    opt = optax.sgd(W.SGD_LR)
    mesh = jpar.make_pipeline_mesh(2, 2)
    pparams = jpar.shard_params(stack(params, 2), mesh, rules)
    popt = jax.device_put(
        opt.init(pparams), jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    )
    step = make_step(model, opt, mesh, n_microbatches=4)
    p2, _, loss = jax.jit(step)(pparams, popt, key, *batch)
    return jax.tree.map(np.asarray, jax.device_get(unstack(p2))), float(loss)


def test_pipeline_train_step_matches_plain(runs):
    out, (ctc, params, _, _) = runs
    p2, loss = _jax_step_params(
        ctc, params, jconf.make_pipeline_train_step, jconf.stack_block_params,
        jconf.unstack_block_params, jconf.pipeline_partition_rules, W.ctc_batch(),
        jax.random.PRNGKey(5),
    )
    exp = pconf.state_dict_from_jax(p2)
    for rank in out[4]:
        np.testing.assert_allclose(rank["conformer"]["loss"], loss, rtol=1e-5)
        for k, v in exp.items():
            np.testing.assert_allclose(
                np.asarray(rank["conformer"]["params"][k]), v.numpy(), rtol=1e-4, atol=1e-5,
                err_msg=k,
            )


def test_transducer_pipeline_train_step_matches_plain(runs):
    out, (_, _, rnnt, params) = runs
    p2, loss = _jax_step_params(
        rnnt, params, jtrans.make_transducer_pipeline_train_step,
        jtrans.transducer_stack_block_params, jtrans.transducer_unstack_block_params,
        jtrans.transducer_pipeline_partition_rules, W.rnnt_batch(), jax.random.PRNGKey(6),
    )
    exp = ptrans.state_dict_from_jax(p2)
    for rank in out[4]:
        np.testing.assert_allclose(rank["transducer"]["loss"], loss, rtol=1e-5)
        for k, v in exp.items():
            np.testing.assert_allclose(
                np.asarray(rank["transducer"]["params"][k]), v.numpy(), rtol=1e-4, atol=1e-5,
                err_msg=k,
            )


def test_shard_params_divisibility_fallback(runs):
    """``conformer_partition_rules`` through ``shard_params`` on a (1, 2)
    mesh: the JAX package's layout in PyTorch's (out, in) weights, the
    V + 1 = 33-row CTC head replicated by the fallback, every DTensor's
    full tensor the weight bit for bit."""
    out, (_, params, _, _) = runs
    jspecs = jpar.param_partition_specs(params, jpar.make_mesh(2), jconf.conformer_partition_rules)
    jsharded = [
        s for s in jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)) if any(a is not None for a in s)
    ]
    for rank in out[2]:
        sh = rank["sharding"]
        assert sh["full_exact"]
        assert sh["specs"]["ctc_head.weight"] == []
        assert jspecs["ctc_head"]["kernel"] == jax.sharding.PartitionSpec()
        assert sh["specs"]["block_0.ffn1.wi.weight"] == ["model", None]
        assert tuple(jspecs["block_0"]["ffn1"]["wi"]["kernel"]) == (None, "model")
        assert sh["specs"]["block_0.ffn1.wo.weight"] == [None, "model"]
        assert sh["specs"]["block_0.mhsa.attn.query.weight"] == ["model", None]
        assert len(sh["sharded"]) == len(jsharded)
        assert sh["local_shapes"]["block_0.ffn1.wi.weight"] == [32, 16]


def test_sharded_checkpoint_round_trip(runs):
    """An asynchronous save of the (1, 2)-sharded parameters, waited for and
    restored into the template's placements, bit for bit; a second save
    replaces the directory."""
    out, _ = runs
    for rank in out[2]:
        sh = rank["sharding"]
        assert sh["restored_local_exact"] and sh["restored_placements"]
        assert not sh["stray_left"]


def test_sharded_ctc_artifact_matches_unsharded_live(runs):
    """A (2, 2) mesh artifact served by four ranks, each its rows, equals
    the JAX package's greedy decode; a 3-row call pads onto the mesh and
    slices back."""
    out, (ctc, params, _, _) = runs
    feats, lens = W.ctc_batch(N=4)[:2]
    logits, out_lens = ctc.apply({"params": params}, feats, lens)
    from pydrobert_tpu.ops.decoding import ctc_greedy_search

    _, hyps, hyp_lens = ctc_greedy_search(logits, out_lens, batch_first=True)
    for rank in out[4]:
        art = rank["artifact"]
        assert art["mesh"] == [2, 2]
        np.testing.assert_array_equal(art["lens"], np.asarray(hyp_lens))
        np.testing.assert_array_equal(art["hyps"], np.asarray(hyps))
        np.testing.assert_array_equal(art["lens3"], np.asarray(hyp_lens)[:3])
        np.testing.assert_array_equal(art["hyps3"], np.asarray(hyps)[:3])
