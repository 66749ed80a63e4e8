"""Name-level inventory of the port: every name in the ``__all__`` of each
JAX module that a port slice has covered exists in its counterpart in
``pydrobert_tpu_torch``, except the names that ROADMAP.md still queues
(``QUEUED``). Each slice that ports a queued name removes it from
``QUEUED``; the test fails while a queued name is already ported, so the
list can only shrink."""

import importlib

import pytest

MODULES = [
    "argcheck",
    "command_line",
    "data",
    "data.dataloaders",
    "data.datasets",
    "data.params",
    "datamodule",
    "distributions",
    "estimators",
    "functional",
    "lm",
    "models.conformer",
    "models.seq2seq",
    "models.transducer",
    "modules",
    "ops.attn",
    "ops.combinatorics",
    "ops.decoding",
    "ops.feats",
    "ops.img",
    "ops.mc",
    "ops.pad",
    "ops.rl",
    "ops.straight_through",
    "ops.string",
    "ops.transducer",
    "serving",
    "training",
    "utils.pytree",
    "utils.serial",
]

# names still to port (ROADMAP.md queue A), by module: A7b (the tar
# dataset, the other CLI commands, the trn/ctm/TextGrid parsers) and A8
# (the pipeline and sharding helpers of the models)
QUEUED = {
    "command_line": {
        "arpa_lm_to_state_dict",
        "chunk_torch_spect_data_dir",
        "compute_mvn_stats_for_torch_feat_data_dir",
        "ctm_to_torch_token_data_dir",
        "print_arpa_lm_state_dict_info",
        "print_torch_ali_data_dir_length_moments",
        "print_torch_ref_data_dir_length_moments",
        "subset_torch_spect_data_dir",
        "textgrids_to_torch_token_data_dir",
        "torch_ali_data_dir_to_torch_token_data_dir",
        "torch_logit_data_dir_to_torch_ali_data_dir",
        "torch_spect_data_dir_to_wds",
        "torch_token_data_dir_to_ctm",
        "torch_token_data_dir_to_textgrids",
        "torch_token_data_dir_to_torch_ali_data_dir",
        "torch_token_data_dir_to_trn",
        "trn_to_torch_token_data_dir",
    },
    "data": {
        "SpectTarDataSet",
        "read_ctm",
        "read_textgrid",
        "read_trn",
        "read_trn_iter",
        "write_ctm",
        "write_textgrid",
        "write_trn",
    },
    "data.datasets": {"SpectTarDataSet"},
    "models.conformer": {
        "conformer_partition_rules",
        "make_pipeline_train_step",
        "make_pipelined_forward",
        "pipeline_partition_rules",
        "pipelined_encoder_forward",
        "stack_block_params",
        "unstack_block_params",
    },
    "models.transducer": {
        "make_transducer_pipeline_train_step",
        "transducer_partition_rules",
        "transducer_pipeline_partition_rules",
        "transducer_stack_block_params",
        "transducer_unstack_block_params",
    },
}


@pytest.mark.parametrize("name", MODULES)
def test_port_has_every_public_name(name):
    jmod = importlib.import_module(f"pydrobert_tpu.{name}")
    pmod = importlib.import_module(f"pydrobert_tpu_torch.{name}")
    queued = QUEUED.get(name, set())
    missing = sorted(n for n in jmod.__all__ if n not in queued and not hasattr(pmod, n))
    assert not missing, f"pydrobert_tpu_torch.{name} lacks {missing}"
    listed = sorted(n for n in jmod.__all__ if n not in queued and n not in pmod.__all__)
    assert not listed, f"pydrobert_tpu_torch.{name}.__all__ lacks {listed}"
    done = sorted(n for n in queued if hasattr(pmod, n))
    assert not done, f"{done} are ported: take them off QUEUED"
    assert queued <= set(jmod.__all__)
