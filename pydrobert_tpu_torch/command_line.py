"""Console commands for SpectDataSet directories, transcripts, alignments,
LMs and scoring (counterpart of :mod:`pydrobert_tpu.command_line`).

Each command is a function of an argument list that returns an exit code,
with the JAX package's flags and file formats: files written by either
package's commands read in the other's. Run one as::

    python -m pydrobert_tpu_torch.command_line <command> [args ...]

where ``<command>`` is the function's name with dashes
(``compute-torch-token-data-dir-error-rates``) or underscores. Commands that
compute take ``--device`` (``cuda`` by default): error rates run through
:func:`pydrobert_tpu_torch.ops.string.error_rate` (each ``--batch-size``
batch of uniform-cost rates is one launch of the edit-distance kernel on a
card), MVN statistics through
:class:`~pydrobert_tpu_torch.modules.MeanVarianceNormalization`, chunking
through ``slice_spect_data``, ``chunk_by_slices`` and
``chunk_token_sequences_by_slices``, logit alignment through
:func:`~pydrobert_tpu_torch.ops.decoding.ctc_forced_align`, and ARPA
compilation through :class:`~pydrobert_tpu_torch.lm.LookupLanguageModel`.
With ``--num-workers`` the per-utterance work fans out over a pool of
spawned processes (a forked child cannot use CUDA once its parent has).
"""

import argparse
import io
import itertools
import math
import os
import random
import shutil
import sys
import tarfile
import warnings
from collections import OrderedDict, defaultdict
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from . import config, data, default_device
from .data.datasets import _info_and_validate
from .utils.serial import load_tensor, save_tensor

__all__ = [
    "arpa_lm_to_state_dict",
    "chunk_torch_spect_data_dir",
    "compute_mvn_stats_for_torch_feat_data_dir",
    "compute_torch_token_data_dir_error_rates",
    "ctm_to_torch_token_data_dir",
    "get_torch_spect_data_dir_info",
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
]

_COMMON_ARGS = {
    "--file-prefix": {
        "default": config.DEFT_FILE_PREFIX,
        "help": "Prefix marking a tensor data file in the directory",
    },
    "--file-suffix": {
        "default": config.DEFT_FILE_SUFFIX,
        "help": "Suffix marking a tensor data file in the directory",
    },
    "token2id": {
        "type": argparse.FileType("r"),
        "help": "Token-to-ID mapping file, one entry per line in the "
        'format "<token> <id>" (tokens are e.g. words or phones). Pass '
        '"--swap" if the file lists "<id> <token>" instead',
    },
    "id2token": {
        "type": argparse.FileType("r"),
        "help": "ID-to-token mapping file, one entry per line in the "
        'format "<id> <token>" (tokens are e.g. words or phones). Pass '
        '"--swap" if the file lists "<token> <id>" instead',
    },
    "--num-workers": {
        "type": int,
        "default": 0,
        "help": "The number of worker processes to process the data. 0 "
        "(the default) is serial",
    },
    "--swap": {
        "action": "store_true",
        "default": False,
        "help": "Read the token/id mapping file with its two columns in "
        "the opposite order",
    },
    "--unk-symbol": {
        "default": None,
        "help": "Map out-of-vocabulary tokens to this symbol instead of "
        "erroring",
    },
    "--frame-shift-ms": {
        "type": float,
        "default": config.DEFT_FRAME_SHIFT_MS,
        "help": "Milliseconds between consecutive feature frames; converts "
        "segment times in seconds to frame indices and back. For "
        "raw-sample features use 1000 / sample_rate_hz",
    },
    "--skip-frame-times": {
        "action": "store_true",
        "default": False,
        "help": "Store token tensors of shape (R,) — token IDs only — "
        "rather than (R, 3) with segment start/end frames",
    },
    "--feat-sizing": {
        "action": "store_true",
        "default": False,
        "help": "Store token tensors of shape (R, 1) rather than (R, 3), "
        "dropping segment start/end frames (which trn files lack anyway); "
        "the trailing size-1 axis lets the directory double as a "
        "SpectDataSet feature dir",
    },
    "--mp-chunk-size": {
        "type": int,
        "default": config.DEFT_CHUNK_SIZE,
        "help": "Utterances handed to each multiprocessing worker at a "
        "time; trades dispatch overhead against peak memory",
    },
    "--textgrid-suffix": {
        "default": config.DEFT_TEXTGRID_SUFFIX,
        "help": "Suffix marking a TextGrid file in tg_dir",
    },
    "--feat-subdir": {
        "default": config.DEFT_FEAT_SUBDIR,
        "help": "Subdirectory of the data dir holding feature tensors",
    },
    "--ali-subdir": {
        "default": config.DEFT_ALI_SUBDIR,
        "help": "Subdirectory of the data dir holding per-frame alignments",
    },
    "--device": {
        "default": None,
        "help": "The device to compute on (default: cuda)",
    },
    "--ref-subdir": {
        "default": config.DEFT_REF_SUBDIR,
        "help": "Subdirectory of the data dir holding reference token "
        "sequences",
    },
}


def _add_common_arg(parser, flag: str):
    kwargs = _COMMON_ARGS[flag]
    parser.add_argument(flag, **kwargs)


def _as_dir(val):
    if not os.path.isdir(val):
        raise argparse.ArgumentTypeError(f"'{val}' is not a directory")
    return val


def _as_nonnegi(val):
    val = int(val)
    if val < 0:
        raise argparse.ArgumentTypeError(f"{val} is negative")
    return val


def _as_nat(val):
    val = int(float(val))
    if val < 1:
        raise argparse.ArgumentTypeError(f"{val} is not positive")
    return val


def _as_closed01(val):
    val = float(val)
    if not 0 <= val <= 1:
        raise argparse.ArgumentTypeError(f"{val} is not within [0, 1]")
    return val


def _multiprocessor_pattern_generator(items, options, do_work, *args):
    """Yield ``do_work(item, *args)`` per item, through a pool of
    ``options.num_workers`` processes when it is positive (in any order
    then). The workers are spawned: a forked child cannot use CUDA once its
    parent has, and a fork of a process with threads is unsafe."""
    num_workers = getattr(options, "num_workers", 0)
    if num_workers:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
            yield from pool.imap_unordered(
                _StarWorker(do_work, args), items, options.mp_chunk_size
            )
            pool.close()
            pool.join()
    else:
        for item in items:
            yield do_work(item, *args)


class _StarWorker:
    def __init__(self, fn, args):
        self.fn, self.args = fn, args

    def __call__(self, item):
        return self.fn(item, *self.args)


def _multiprocessor_pattern(items, options, do_work, *args):
    for _ in _multiprocessor_pattern_generator(items, options, do_work, *args):
        pass


def get_torch_spect_data_dir_info(args: Optional[Sequence[str]] = None):
    """Write info about the specified SpectDataSet data dir

Writes the space-delimited key-value pairs documented in the reference
command (num_utterances, num_filts, total_frames, total_tokens,
max_ali_class, max_ref_class, count_<i>, segs_<i>, rcount_<i>, rsegs_<i>)
to an output file in sorted order. Output is parseable as a Kaldi text
table of integers."""
    parser = argparse.ArgumentParser(
        description=get_torch_spect_data_dir_info.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("dir", type=_as_dir, help="The torch data directory")
    parser.add_argument(
        "out_file",
        nargs="?",
        type=argparse.FileType("w"),
        default=sys.stdout,
        help="The file to write to. If unspecified, stdout",
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--feat-subdir")
    _add_common_arg(parser, "--ali-subdir")
    _add_common_arg(parser, "--ref-subdir")
    group = parser.add_mutually_exclusive_group()
    group.add_argument(
        "--strict",
        action="store_true",
        default=False,
        help="If set, validate the data directory before collecting info.",
    )
    group.add_argument(
        "--fix",
        nargs="?",
        metavar="N",
        type=_as_nonnegi,
        const=1,
        default=None,
        help="If set, validate the data directory before collecting info, "
        "potentially fixing small errors in the directory (cropping "
        "threshold N, default 1).",
    )
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    data_set = data.SpectDataSet(
        options.dir,
        file_prefix=options.file_prefix,
        file_suffix=options.file_suffix,
        feat_subdir=options.feat_subdir,
        ali_subdir=options.ali_subdir,
        ref_subdir=options.ref_subdir,
        suppress_alis=False,
        tokens_only=False,
    )
    info_dict = _info_and_validate(
        data_set, True, bool(options.strict or options.fix is not None),
        options.fix,
    )
    for key, value in sorted(info_dict.items()):
        options.out_file.write(f"{key} {value}\n")
    if options.out_file != sys.stdout:
        options.out_file.close()
    return 0


def _parse_token2id(file, swap, return_swap):
    ret, ret_swapped = dict(), dict()
    for line_no, line in enumerate(file):
        line = line.strip()
        if not line:
            continue
        ls = line.split()
        if len(ls) != 2 or not ls[1 - int(swap)].lstrip("-").isdigit():
            raise ValueError(
                f"Cannot parse line {line_no + 1} of {file.name}"
            )
        key, value = ls
        key, value = (int(key), value) if swap else (key, int(value))
        if key in ret:
            warnings.warn(
                f'{file.name} line {line_no + 1}: "{key}" already exists. '
                "Mapping will be ambiguous"
            )
        if value in ret_swapped:
            warnings.warn(
                f'{file.name} line {line_no + 1}: "{value}" already exists. '
                "Mapping will be ambiguous"
            )
        ret[key] = value
        ret_swapped[value] = key
    return ret_swapped if return_swap else ret


def _parse_wc2utt(file, swap, return_swap):
    ret, ret_swapped = dict(), dict()
    for line_no, line in enumerate(file):
        line = line.strip()
        if not line:
            continue
        ls = line.split()
        if len(ls) != 3:
            raise ValueError(
                f"Cannot parse line {line_no + 1} of {file.name}"
            )
        if swap:
            value, first, second = ls
        else:
            first, second, value = ls
        key = (first, second)
        if key in ret:
            warnings.warn(
                f'{file.name} line {line_no + 1}: "{key}" already exists. '
                "Mapping will be ambiguous"
            )
        ret[key] = value
        ret_swapped[value] = key
    return ret_swapped if return_swap else ret


def _save_transcripts_to_dir_do_work(
    bt, token2id, dir_, frame_shift_ms, unk, skip_frame_times, feat_sizing
):
    basename, transcript = bt
    tok = data.transcript_to_token(
        transcript,
        token2id,
        frame_shift_ms,
        unk,
        skip_frame_times or feat_sizing,
    )
    if feat_sizing:
        tok = tok[..., None]
    save_tensor(tok, os.path.join(dir_, basename))


def trn_to_torch_token_data_dir(args: Optional[Sequence[str]] = None):
    """Convert a NIST "trn" file to the specified SpectDataSet data dir"""
    parser = argparse.ArgumentParser(
        description=trn_to_torch_token_data_dir.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "trn", type=argparse.FileType("r"), help="The input trn file"
    )
    _add_common_arg(parser, "token2id")
    parser.add_argument(
        "dir",
        help="The directory to store token sequences to. If the directory "
        "does not exist, it will be created",
    )
    parser.add_argument(
        "--alt-handler",
        default="error",
        choices=("error", "first"),
        help='How to handle transcription alternates. If "error", error if '
        'the "trn" file contains alternates. If "first", always treat the '
        "alternate as canon",
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--swap")
    _add_common_arg(parser, "--unk-symbol")
    _add_common_arg(parser, "--num-workers")
    _add_common_arg(parser, "--mp-chunk-size")
    size_group = parser.add_mutually_exclusive_group()
    _add_common_arg(size_group, "--skip-frame-times")
    _add_common_arg(size_group, "--feat-sizing")
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    token2id = _parse_token2id(options.token2id, options.swap, options.swap)
    if options.unk_symbol is not None and options.unk_symbol not in token2id:
        print(
            f'Unk symbol "{options.unk_symbol}" is not in token2id',
            file=sys.stderr,
        )
        return 1
    transcripts = data.read_trn_iter(options.trn)

    def error_handling_iter():
        for utt_id, transcript in transcripts:
            old_transcript = transcript[:]
            transcript[:] = []
            while len(old_transcript):
                x = old_transcript.pop(0)
                if len(x) == 3 and x[1] == -1:
                    x = x[0]
                if isinstance(x, str):
                    transcript.append(x)
                elif options.alt_handler == "error":
                    raise ValueError(f"Cannot handle alternate in '{utt_id}'")
                else:  # first
                    x[0].extend(old_transcript)
                    old_transcript = x[0]
            yield (
                options.file_prefix + utt_id + options.file_suffix,
                transcript,
            )

    os.makedirs(options.dir, exist_ok=True)
    _multiprocessor_pattern(
        error_handling_iter(),
        options,
        _save_transcripts_to_dir_do_work,
        token2id,
        options.dir,
        None,
        options.unk_symbol,
        options.skip_frame_times,
        options.feat_sizing,
    )
    return 0


def _load_transcripts_from_data_dir(
    dir_,
    id2token,
    file_prefix,
    file_suffix,
    frame_shift_ms=None,
    strip_timing=False,
):
    fpl, fsl = len(file_prefix), len(file_suffix)
    utt_ids = sorted(
        x[fpl : len(x) - fsl]
        for x in os.listdir(dir_)
        if x.startswith(file_prefix) and x.endswith(file_suffix)
    )
    for utt_id in utt_ids:
        tok = load_tensor(
            os.path.join(dir_, file_prefix + utt_id + file_suffix)
        )
        transcript = data.token_to_transcript(tok, id2token, frame_shift_ms)
        for idx in range(len(transcript)):
            token = transcript[idx]
            if isinstance(token, tuple):
                token = token[0]
                if strip_timing:
                    transcript[idx] = token
            if isinstance(token, (int, np.integer)) and id2token is not None:
                raise ValueError(
                    f"Utterance '{utt_id}': ID '{token}' could not be found "
                    "in id2token"
                )
        yield utt_id, transcript


def torch_token_data_dir_to_trn(args: Optional[Sequence[str]] = None):
    """Convert a SpectDataSet token data dir to a NIST trn file"""
    parser = argparse.ArgumentParser(
        description=torch_token_data_dir_to_trn.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "dir", type=_as_dir, help="The directory to read token sequences from"
    )
    _add_common_arg(parser, "id2token")
    parser.add_argument(
        "trn",
        type=argparse.FileType("w"),
        help='The "trn" file to write transcriptions to',
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--swap")
    _add_common_arg(parser, "--num-workers")
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    id2token = _parse_token2id(options.id2token, not options.swap, options.swap)
    transcripts = _load_transcripts_from_data_dir(
        options.dir,
        id2token,
        options.file_prefix,
        options.file_suffix,
        strip_timing=True,
    )
    data.write_trn(transcripts, options.trn)
    return 0


def ctm_to_torch_token_data_dir(args: Optional[Sequence[str]] = None):
    """Convert a NIST "ctm" file to the specified SpectDataSet data dir"""
    parser = argparse.ArgumentParser(
        description=ctm_to_torch_token_data_dir.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "ctm",
        type=argparse.FileType("r"),
        help='The "ctm" file to read token segments from',
    )
    _add_common_arg(parser, "token2id")
    parser.add_argument(
        "dir",
        help="The directory to store token sequences to. If the directory "
        "does not exist, it will be created",
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--swap")
    _add_common_arg(parser, "--unk-symbol")
    _add_common_arg(parser, "--num-workers")
    _add_common_arg(parser, "--mp-chunk-size")
    size_group = parser.add_mutually_exclusive_group()
    _add_common_arg(size_group, "--skip-frame-times")
    _add_common_arg(size_group, "--feat-sizing")
    _add_common_arg(size_group, "--frame-shift-ms")
    utt_group = parser.add_mutually_exclusive_group()
    utt_group.add_argument(
        "--wc2utt",
        type=argparse.FileType("r"),
        default=None,
        help="A file mapping wavefile name and channel combinations (e.g. "
        "'utt_1 A') to utterance IDs ('<wavefile_name> <channel> <utt_id>' "
        "per line)",
    )
    utt_group.add_argument(
        "--utt2wc",
        type=argparse.FileType("r"),
        default=None,
        help="A file mapping utterance IDs to wavefile name and channel "
        "combinations ('<utt_id> <wavefile_name> <channel>' per line)",
    )
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    token2id = _parse_token2id(options.token2id, options.swap, options.swap)
    if options.unk_symbol is not None and options.unk_symbol not in token2id:
        print(
            f'Unk symbol "{options.unk_symbol}" is not in token2id',
            file=sys.stderr,
        )
        return 1
    if options.wc2utt:
        wc2utt = _parse_wc2utt(options.wc2utt, False, False)
    elif options.utt2wc:
        wc2utt = _parse_wc2utt(options.utt2wc, True, False)
    else:
        wc2utt = None
    transcripts = (
        (options.file_prefix + x[0] + options.file_suffix, x[1])
        for x in data.read_ctm(options.ctm, wc2utt)
    )
    os.makedirs(options.dir, exist_ok=True)
    _multiprocessor_pattern(
        transcripts,
        options,
        _save_transcripts_to_dir_do_work,
        token2id,
        options.dir,
        options.frame_shift_ms,
        options.unk_symbol,
        options.skip_frame_times,
        options.feat_sizing,
    )
    return 0


def torch_token_data_dir_to_ctm(args: Optional[Sequence[str]] = None):
    """Convert a SpectDataSet token data directory to a NIST "ctm" file"""
    parser = argparse.ArgumentParser(
        description=torch_token_data_dir_to_ctm.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "dir", type=_as_dir, help="The directory to read token sequences from"
    )
    _add_common_arg(parser, "id2token")
    parser.add_argument(
        "ctm",
        type=argparse.FileType("w"),
        help='The "ctm" file to write token segments to',
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--swap")
    _add_common_arg(parser, "--frame-shift-ms")
    utt_group = parser.add_mutually_exclusive_group()
    utt_group.add_argument(
        "--wc2utt",
        type=argparse.FileType("r"),
        default=None,
        help="A file mapping wavefile name and channel combinations to "
        "utterance IDs",
    )
    utt_group.add_argument(
        "--utt2wc",
        type=argparse.FileType("r"),
        default=None,
        help="A file mapping utterance IDs to wavefile name and channel "
        "combinations",
    )
    parser.add_argument(
        "--channel",
        default=config.DEFT_CTM_CHANNEL,
        help="If neither "
        "'--wc2utt' nor '--utt2wc' is specified, utterance IDs are treated "
        "as wavefile names and are given the value of this flag as a "
        "channel",
    )
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    id2token = _parse_token2id(options.id2token, not options.swap, options.swap)
    if options.wc2utt:
        utt2wc = _parse_wc2utt(options.wc2utt, False, True)
    elif options.utt2wc:
        utt2wc = _parse_wc2utt(options.utt2wc, True, True)
    else:
        utt2wc = options.channel
    transcripts = _load_transcripts_from_data_dir(
        options.dir,
        id2token,
        options.file_prefix,
        options.file_suffix,
        options.frame_shift_ms,
    )
    data.write_ctm(list(transcripts), options.ctm, utt2wc)
    return 0


def textgrids_to_torch_token_data_dir(args: Optional[Sequence[str]] = None):
    """Convert a directory of TextGrid files into a SpectDataSet ref/ dir"""
    parser = argparse.ArgumentParser(
        description=textgrids_to_torch_token_data_dir.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "tg_dir",
        type=_as_dir,
        help="The directory containing the TextGrid files",
    )
    _add_common_arg(parser, "token2id")
    parser.add_argument(
        "dir",
        help="The directory to store token sequences to. If the directory "
        "does not exist, it will be created",
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--swap")
    _add_common_arg(parser, "--unk-symbol")
    _add_common_arg(parser, "--num-workers")
    _add_common_arg(parser, "--mp-chunk-size")
    _add_common_arg(parser, "--textgrid-suffix")
    parser.add_argument(
        "--fill-symbol",
        default=None,
        help="If set, unlabelled intervals in the TextGrid files will be "
        "assigned this symbol.",
    )
    size_group = parser.add_mutually_exclusive_group()
    _add_common_arg(size_group, "--skip-frame-times")
    _add_common_arg(size_group, "--feat-sizing")
    _add_common_arg(size_group, "--frame-shift-ms")
    tier_grp = parser.add_mutually_exclusive_group()
    tier_grp.add_argument(
        "--tier-name", dest="tier_id", help="The name of the tier to extract."
    )
    tier_grp.add_argument(
        "--tier-idx",
        dest="tier_id",
        type=int,
        help="The index of the tier to extract.",
    )
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    token2id = _parse_token2id(options.token2id, options.swap, options.swap)
    if options.unk_symbol is not None and options.unk_symbol not in token2id:
        print(
            f"Unk symbol '{options.unk_symbol}' is not in token2id",
            file=sys.stderr,
        )
        return 1
    if options.fill_symbol is not None and options.fill_symbol not in token2id:
        print(
            f"Fill symbol '{options.fill_symbol}' is not in token2id",
            file=sys.stderr,
        )
        return 1
    if options.tier_id is None:
        options.tier_id = config.DEFT_TEXTGRID_TIER_ID

    def textgrid_iter():
        for file_name in sorted(os.listdir(options.tg_dir)):
            if not file_name.endswith(
                options.textgrid_suffix
            ) or not file_name.startswith(options.file_prefix):
                continue
            basename = (
                file_name[: len(file_name) - len(options.textgrid_suffix)]
                + options.file_suffix
            )
            yield basename, data.read_textgrid(
                os.path.join(options.tg_dir, file_name),
                options.tier_id,
                options.fill_symbol,
            )[0]

    os.makedirs(options.dir, exist_ok=True)
    _multiprocessor_pattern(
        textgrid_iter(),
        options,
        _save_transcripts_to_dir_do_work,
        token2id,
        options.dir,
        options.frame_shift_ms,
        options.unk_symbol,
        options.skip_frame_times,
        options.feat_sizing,
    )
    return 0


def _tg_item_worker(item, *fixed):
    """Pool-picklable adapter: per-utterance names ride in `item`, shared
    options in `fixed` (multiprocessing pickles the worker)."""
    utt_id, in_name, out_name = item
    ref_dir, id2tok, feat_dir, tg_dir = fixed[:4]
    return _token_dir_to_textgrids_do_work(
        utt_id, ref_dir, id2tok, feat_dir, tg_dir, in_name, out_name,
        *fixed[4:],
    )


def _token_dir_to_textgrids_do_work(
    utt_id,
    ref_dir,
    id2token,
    feat_dir,
    tg_dir,
    in_name,
    out_name,
    frame_shift_ms,
    tier_name,
    precision,
    quiet,
    force_method,
):
    ref_name = os.path.join(ref_dir, in_name)
    ref = load_tensor(ref_name).numpy()
    err_msg = f"Failure converting '{ref_name}' to TextGrid:"
    has_segment_index = ref.ndim == 2 and ref.shape[1] == 3
    if not has_segment_index and ref.ndim != 1:
        raise ValueError(f"{err_msg} tensor is an invalid size")
    if feat_dir is not None:
        feat_name = os.path.join(feat_dir, in_name)
        if not os.path.isfile(feat_name):
            raise ValueError(
                f"{err_msg} corresponding feature file '{feat_name}' does "
                "not exist"
            )
        feat = load_tensor(feat_name)
        if feat.ndim != 2:
            raise ValueError(f"{err_msg} feature tensor is an invalid size")
        T = feat.shape[0]
    elif has_segment_index and ref.size:
        T = int(ref[..., 1:].max())
    else:
        if not quiet:
            warnings.warn(
                f"Could not determine length of '{ref_name}'. Setting to 0"
            )
        T = 0
    T = (T * frame_shift_ms) / 1000
    ref = np.array(ref)
    try_method = force_method if force_method else 1
    point_tier = None
    if try_method == 1:
        if (
            has_segment_index
            and ref.size
            and ((ref[..., 2] > ref[..., 1]) & (ref[..., 1] >= 0)).all()
        ):
            point_tier = False
        elif force_method:
            raise ValueError(f"{err_msg} does not have enough info for method 1")
        else:
            try_method += 1
    if try_method == 2:
        maxes = (
            ref[..., 1:].max(1)
            if has_segment_index and ref.size
            else np.asarray(-1)
        )
        if has_segment_index and ref.size and (maxes >= 0).all():
            ref[..., 1:] = maxes[:, None]
            point_tier = True
        elif force_method:
            raise ValueError(f"{err_msg} does not have enough info for method 2")
        else:
            try_method += 1
    if try_method == 3:
        transcript = data.token_to_transcript(
            ref[..., 0] if has_segment_index else ref, id2token
        )
        text = " ".join(str(t) for t in transcript)
        transcript = [(text, 0.0, T)]
        point_tier = False
    else:
        transcript = data.token_to_transcript(ref, id2token, frame_shift_ms)
    data.write_textgrid(
        transcript,
        os.path.join(tg_dir, out_name),
        0.0,
        max(T, max((x[2] for x in transcript if not isinstance(x, str)), default=0.0))
        if not isinstance(transcript[0], str)
        else T,
        tier_name,
        point_tier,
        precision,
    )


def torch_token_data_dir_to_textgrids(args: Optional[Sequence[str]] = None):
    """Convert a SpectDataSet ref/ dir into a directory of TextGrid files"""
    parser = argparse.ArgumentParser(
        description=torch_token_data_dir_to_textgrids.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "ref_dir",
        type=_as_dir,
        help="The token sequence data directory (input)",
    )
    _add_common_arg(parser, "id2token")
    parser.add_argument("tg_dir", help="The TextGrid directory (output)")
    len_opt = parser.add_mutually_exclusive_group(required=True)
    len_opt.add_argument("--feat-dir", default=None, help="Path to features")
    len_opt.add_argument(
        "--infer",
        action="store_true",
        default=False,
        help="Infer lengths based on maximum segment boundaries",
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--swap")
    _add_common_arg(parser, "--frame-shift-ms")
    _add_common_arg(parser, "--num-workers")
    _add_common_arg(parser, "--mp-chunk-size")
    _add_common_arg(parser, "--textgrid-suffix")
    parser.add_argument(
        "--tier-name",
        default=config.DEFT_TEXTGRID_TIER_NAME,
        help="The name to save the tier with",
    )
    parser.add_argument(
        "--precision",
        type=_as_nonnegi,
        default=config.DEFT_FLOAT_PRINT_PRECISION,
        help="Precision with which to save floating point values",
    )
    parser.add_argument(
        "--quiet", action="store_true", default=False,
        help="Suppress warnings when lengths cannot be determined",
    )
    parser.add_argument(
        "--force-method",
        default=None,
        type=int,
        choices=[1, 2, 3],
        help="Force a specific method of writing to TextGrid.",
    )
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    id2token = _parse_token2id(options.id2token, not options.swap, options.swap)
    fpl, fsl = len(options.file_prefix), len(options.file_suffix)
    utt_ids = sorted(
        x[fpl : len(x) - fsl]
        for x in os.listdir(options.ref_dir)
        if x.startswith(options.file_prefix)
        and x.endswith(options.file_suffix)
    )
    os.makedirs(options.tg_dir, exist_ok=True)

    # fan out over utterances with the shared worker-pool pattern; the
    # (in_name, out_name) pair varies per utterance so it rides in the item
    items = (
        (
            utt_id,
            options.file_prefix + utt_id + options.file_suffix,
            options.file_prefix + utt_id + options.textgrid_suffix,
        )
        for utt_id in utt_ids
    )

    for _ in _multiprocessor_pattern_generator(
        items,
        options,
        _tg_item_worker,
        options.ref_dir,
        id2token,
        options.feat_dir,
        options.tg_dir,
        options.frame_shift_ms,
        options.tier_name,
        options.precision,
        options.quiet,
        options.force_method,
    ):
        pass
    return 0


def compute_torch_token_data_dir_error_rates(
    args: Optional[Sequence[str]] = None,
):
    """Compute error rates between reference and hypothesis token data dirs

Computes the total or per-utterance error rate (or distance) between ref/
and hyp/ subdirectories as the total errors over the sum of reference
lengths. Supports replacement/ignore maps and NIST costs, as the reference
command does."""
    parser = argparse.ArgumentParser(
        description=compute_torch_token_data_dir_error_rates.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "dir",
        type=_as_dir,
        help="If the 'hyp' argument is not specified, the parent of 'ref/' "
        "and 'hyp/'; otherwise the reference transcript directory",
    )
    parser.add_argument(
        "hyp",
        nargs="?",
        type=_as_dir,
        default=None,
        help="The hypothesis transcript directory",
    )
    parser.add_argument(
        "out",
        nargs="?",
        type=argparse.FileType("w"),
        default=sys.stdout,
        help="Where to print the error rate to. Defaults to stdout",
    )
    parser.add_argument(
        "--id2token",
        type=argparse.FileType("r"),
        default=None,
        help=_COMMON_ARGS["id2token"]["help"],
    )
    parser.add_argument(
        "--replace",
        type=argparse.FileType("r"),
        default=None,
        help="A file containing pairs of elements per line: the element to "
        "replace and its replacement. Processed before '--ignore'",
    )
    parser.add_argument(
        "--ignore",
        type=argparse.FileType("r"),
        default=None,
        help="A file containing a whitespace-delimited list of elements to "
        "ignore. Processed after '--replace'",
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--swap")
    parser.add_argument(
        "--warn-missing",
        action="store_true",
        default=False,
        help="Warn and exclude utterances missing a transcript (default: "
        "error)",
    )
    parser.add_argument(
        "--distances",
        action="store_true",
        default=False,
        help="Return the average distance per utterance instead",
    )
    parser.add_argument(
        "--per-utt",
        action="store_true",
        default=False,
        help="Print lines of '<utt_id> <error_rate>' instead of the average",
    )
    parser.add_argument(
        "--batch-size",
        type=_as_nat,
        default=100,
        help="The number of error rates to compute at once",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="The device to compute error rates on (default: cuda)",
    )
    parser.add_argument(
        "--quiet",
        action="store_true",
        default=False,
        help="Suppress warnings from edit distance computations",
    )
    group = parser.add_mutually_exclusive_group()
    group.add_argument(
        "--costs",
        nargs=3,
        type=float,
        metavar=("INS", "DEL", "SUB"),
        default=(
            config.DEFT_INS_COST,
            config.DEFT_DEL_COST,
            config.DEFT_SUB_COST,
        ),
        help="The costs of insertion, deletion, and substitution",
    )
    group.add_argument(
        "--nist-costs",
        action="store_true",
        default=False,
        help="Use NIST (sclite) costs for ins/del/subs (3/3/4)",
    )
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    from .ops.string import error_rate

    device = default_device(options.device)

    if options.nist_costs:
        options.costs = (3.0, 3.0, 4.0)
    if options.hyp:
        ref_dir, hyp_dir = options.dir, options.hyp
    else:
        ref_dir = os.path.join(options.dir, "ref")
        hyp_dir = os.path.join(options.dir, "hyp")
    for d in (ref_dir, hyp_dir):
        if not os.path.isdir(d):
            print(f'"{d}" is not a directory', file=sys.stderr)
            return 1
    if options.id2token:
        id2token = _parse_token2id(
            options.id2token, not options.swap, options.swap
        )
    else:
        id2token = None
    replace = dict()
    if options.replace:
        for line in options.replace:
            replaced, replacement = line.strip().split()
            if id2token is None:
                try:
                    replaced, replacement = int(replaced), int(replacement)
                except ValueError:
                    raise ValueError(
                        f'If --id2token is not set, all elements in '
                        f'"{options.replace.name}" must be integers'
                    )
            replace[replaced] = replacement
    if options.ignore:
        ignore = set(options.ignore.read().strip().split())
        if id2token is None:
            try:
                ignore = {int(x) for x in ignore}
            except ValueError:
                raise ValueError(
                    f'If --id2token is not set, all elements in '
                    f'"{options.ignore.name}" must be integers'
                )
    else:
        ignore = set()
    ref_transcripts = list(
        _load_transcripts_from_data_dir(
            ref_dir,
            id2token,
            options.file_prefix,
            options.file_suffix,
            strip_timing=True,
        )
    )
    hyp_transcripts = list(
        _load_transcripts_from_data_dir(
            hyp_dir,
            id2token,
            options.file_prefix,
            options.file_suffix,
            strip_timing=True,
        )
    )
    idx = 0
    while idx < max(len(ref_transcripts), len(hyp_transcripts)):
        missing_ref = missing_hyp = False
        if idx == len(ref_transcripts):
            missing_hyp = True
        elif idx == len(hyp_transcripts):
            missing_ref = True
        elif ref_transcripts[idx][0] < hyp_transcripts[idx][0]:
            missing_ref = True
        elif hyp_transcripts[idx][0] < ref_transcripts[idx][0]:
            missing_hyp = True
        if missing_hyp or missing_ref:
            if missing_hyp:
                fmt_tup = hyp_dir, hyp_transcripts[idx][0], ref_dir
                del hyp_transcripts[idx]
            else:
                fmt_tup = ref_dir, ref_transcripts[idx][0], hyp_dir
                del ref_transcripts[idx]
            msg = (
                'Directory "{}" contains utterance "{}" which directory '
                '"{}" does not contain'
            ).format(*fmt_tup)
            if options.warn_missing:
                warnings.warn(msg + ". Skipping")
            else:
                raise ValueError(msg)
        else:
            idx += 1
    idee_, eos, padding = [0], -1, -2

    def get_idee():
        v = idee_[0]
        idee_[0] += 1
        return v

    token2id = defaultdict(get_idee)
    error_rates = OrderedDict()
    tot_errs = 0
    total_ref_tokens = 0.0
    while len(ref_transcripts):
        batch_ref = [
            (
                utt,
                [
                    token2id[replace.get(t, t)]
                    for t in transcript
                    if replace.get(t, t) not in ignore
                ],
            )
            for (utt, transcript) in ref_transcripts[: options.batch_size]
        ]
        batch_hyp = [
            (
                utt,
                [
                    token2id[replace.get(t, t)]
                    for t in transcript
                    if replace.get(t, t) not in ignore
                ],
            )
            for (utt, transcript) in hyp_transcripts[: options.batch_size]
        ]
        ref_transcripts = ref_transcripts[options.batch_size :]
        hyp_transcripts = hyp_transcripts[options.batch_size :]

        def pad(batch):
            maxlen = max(len(t) + 1 for _, t in batch)
            # round the length up to a multiple of 32, as the JAX package
            # does: a few bucketed shapes
            maxlen = -(-maxlen // 32) * 32
            out = np.full((maxlen, len(batch)), padding, np.int64)
            for n, (_, t) in enumerate(batch):
                out[: len(t), n] = t
                out[len(t), n] = eos
            return torch.from_numpy(out).to(device)

        ers = error_rate(
            pad(batch_ref),
            pad(batch_hyp),
            eos=eos,
            include_eos=False,
            ins_cost=options.costs[0],
            del_cost=options.costs[1],
            sub_cost=options.costs[2],
            norm=False,
            warn=not options.quiet,
        )
        ers = ers.cpu().numpy()
        for (utt_id, transcript), er in zip(batch_ref, ers):
            error_rates[utt_id] = float(er) / (
                1 if options.distances else len(transcript)
            )
            tot_errs += float(er)
            total_ref_tokens += len(transcript)
    if options.per_utt:
        for utt_id, er in error_rates.items():
            options.out.write(f"{utt_id} {er}\n")
    else:
        options.out.write(
            "{}\n".format(
                tot_errs
                / (len(error_rates) if options.distances else total_ref_tokens)
            )
        )
    return 0


def torch_spect_data_dir_to_wds(args: Optional[Sequence[str]] = None):
    """Convert a SpectDataSet to a WebDataset tar archive

Archives contain ``<utt>.feat.pth`` (+ ``.ali.pth``/``.ref.pth``) entries,
optionally sharded by sample count/bytes."""
    parser = argparse.ArgumentParser(
        description=torch_spect_data_dir_to_wds.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("dir", type=_as_dir, help="The torch data directory")
    parser.add_argument("tar_path", help="The path to store files to")
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--feat-subdir")
    _add_common_arg(parser, "--ali-subdir")
    _add_common_arg(parser, "--ref-subdir")
    parser.add_argument(
        "--shard",
        action="store_true",
        default=False,
        help="Split samples among multiple tar files ('tar_path' gains a "
        "suffix '.x' with the shard number)",
    )
    parser.add_argument(
        "--max-samples-per-shard",
        type=_as_nat,
        default=int(1e5),
        help="Max samples per shard when sharding",
    )
    parser.add_argument(
        "--max-size-per-shard",
        type=_as_nat,
        default=int(3e9),
        help="Max size in bytes per shard when sharding",
    )
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    data_set = data.SpectDataSet(
        options.dir,
        file_prefix=options.file_prefix,
        file_suffix=options.file_suffix,
        feat_subdir=options.feat_subdir,
        ali_subdir=options.ali_subdir,
        ref_subdir=options.ref_subdir,
        suppress_alis=False,
        tokens_only=False,
    )
    pattern = Path(options.tar_path)
    if pattern.parent != Path("."):
        os.makedirs(pattern.parent, exist_ok=True)
    if pattern.suffix in {".tgz", ".gz"}:
        compression = "gz"
    elif pattern.suffix == ".bz2":
        compression = "bz2"
    elif pattern.suffix == ".xz":
        compression = "xz"
    else:
        compression = ""
    pattern = str(pattern)
    NN = len(data_set)
    if options.shard:
        max_bytes = options.max_size_per_shard
        max_count = options.max_samples_per_shard
        max_num_shards = (NN - 1) // max_count + 1
        max_shard = max(max_num_shards - 1, 1)
        pattern += f".{{shard:0{int(math.ceil(math.log(max_shard)))}d}}"
    else:
        max_bytes = float("inf")
        max_count = NN
    cur_count = cur_bytes = shard = 0
    cur_tar = tarfile.open(pattern.format(shard=shard), f"w|{compression}")
    for idx in range(NN):
        feat, ali, ref = data_set[idx]
        utt_id = data_set.utt_ids[idx]
        if cur_count >= max_count or cur_bytes >= max_bytes:
            cur_tar.close()
            shard += 1
            cur_count = cur_bytes = 0
            cur_tar = tarfile.open(
                pattern.format(shard=shard), f"w|{compression}"
            )
        for name, tensor in (("ali", ali), ("feat", feat), ("ref", ref)):
            if tensor is None:
                continue
            # save_tensor's file, written to memory: a contiguous copy of
            # just the tensor's elements, found by the tar reader's
            # byte-range index
            buf = io.BytesIO()
            torch.save(tensor.detach().cpu().contiguous().clone(), buf)
            buf.seek(0)
            member = tarfile.TarInfo(f"{utt_id}.{name}.pth")
            member.size = len(buf.getbuffer())
            cur_tar.addfile(member, buf)
            cur_bytes += member.size
        cur_count += 1
    cur_tar.close()
    return 0


def compute_mvn_stats_for_torch_feat_data_dir(
    args: Optional[Sequence[str]] = None,
):
    """Compute mean and standard deviation over a torch feature directory

Stores the statistics (or a dict of per-group statistics with --id2gid) to
the output path as a pickle of numpy arrays. The float64 sums run on
--device (default: cuda)."""
    parser = argparse.ArgumentParser(
        description=compute_mvn_stats_for_torch_feat_data_dir.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("dir", type=_as_dir, help="The feature directory")
    parser.add_argument("out", help="Output path")
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--num-workers")
    _add_common_arg(parser, "--device")
    parser.add_argument(
        "--dim", type=int, default=-1,
        help="The dimension of the feature vector",
    )
    parser.add_argument(
        "--id2gid",
        type=argparse.FileType("r"),
        default=None,
        help="Path to a file mapping feature tensors to groups "
        "('<id> <gid>' per line); stats are computed per group",
    )
    parser.add_argument(
        "--bessel",
        action="store_true",
        default=False,
        help="Apply Bessel's correction to estimates",
    )
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    from .modules import MeanVarianceNormalization

    device = default_device(options.device)

    if options.id2gid is not None:
        id2gid = dict()
        for ln, line in enumerate(options.id2gid):
            line = line.strip().split()
            if not len(line):
                continue
            if len(line) != 2:
                print(
                    f"{options.id2gid.name} line {ln + 1}: expected two ids, "
                    f"got {len(line)}",
                    file=sys.stderr,
                )
                return 1
            id_, gid = line
            if id_ in id2gid:
                print(
                    f"{options.id2gid.name} line {ln + 1}: duplicate entry "
                    f"for id '{id_}'",
                    file=sys.stderr,
                )
                return 1
            id2gid[id_] = gid
        gid2mvn = dict((x, None) for x in id2gid.values())
    else:
        id2gid = defaultdict(lambda: None)
        gid2mvn = {None: None}
    fpl, fsl = len(options.file_prefix), len(options.file_suffix)
    utt_ids = sorted(
        x[fpl : len(x) - fsl]
        for x in os.listdir(options.dir)
        if x.startswith(options.file_prefix)
        and x.endswith(options.file_suffix)
    )
    for utt_id in utt_ids:
        try:
            gid = id2gid[utt_id]
        except KeyError:
            print(
                f"'{options.dir}' id '{utt_id}' was not listed in "
                f"'{options.id2gid.name}'",
                file=sys.stderr,
            )
            return 1
        x = load_tensor(
            os.path.join(
                options.dir,
                options.file_prefix + utt_id + options.file_suffix,
            )
        )
        mvn = gid2mvn[gid]
        if mvn is None:
            gid2mvn[gid] = mvn = MeanVarianceNormalization(options.dim)
        mvn.accumulate(x.to(device))
    gid2stats = dict()
    for gid, mvn in gid2mvn.items():
        if mvn is None:
            if gid is None:
                print("No features - no stats!", file=sys.stderr)
                return 1
            print(
                f"Gid '{gid}' had no accumulated stats - not saving",
                file=sys.stderr,
            )
            continue
        count = mvn.count
        mvn.store(delete_stats=False)
        std = mvn.std
        if options.bessel and count > 1:
            var = (std.astype(np.float64) ** 2) * count / (count - 1)
            std = np.sqrt(var).astype(np.float32)
        gid2stats[gid] = {"mean": mvn.mean, "std": std}
    if set(gid2stats) == {None}:
        gid2stats = gid2stats[None]
    import pickle

    with open(options.out, "wb") as f:
        pickle.dump(gid2stats, f)
    return 0


def _token_dir_to_ali_dir_do_work(basename, ref_dir, ali_dir, feat_dir=None):
    ref_path = os.path.join(ref_dir, basename)
    ref = load_tensor(ref_path).numpy()
    err_msg = f"Error converting '{ref_path}' to ali:"
    if ref.ndim != 2 or ref.shape[0] == 0 or ref.shape[1] != 3:
        raise ValueError(f"{err_msg} invalid size '{ref.shape}'")
    if (ref[:, 1:] < 0).any():
        raise ValueError(f"{err_msg} some token boundaries missing")
    if ref[0, 1] != 0:
        raise ValueError(f"{err_msg} starts at frame {ref[0, 1]}, not 0")
    if (ref[:-1, 2] != ref[1:, 1]).any():
        raise ValueError(f"{err_msg} not all boundaries are contiguous")
    if feat_dir is not None:
        feat_path = os.path.join(feat_dir, basename)
        T = load_tensor(feat_path).shape[0]
        if ref[-1, 2] != T:
            raise ValueError(
                f"{err_msg} feats at '{feat_path}' report {T} frames. ref "
                f"ends with {ref[-1, 2]}"
            )
    ali = np.repeat(ref[:, 0], ref[:, 2] - ref[:, 1]).astype(np.int64)
    save_tensor(ali, os.path.join(ali_dir, basename))


def torch_token_data_dir_to_torch_ali_data_dir(
    args: Optional[Sequence[str]] = None,
):
    """Convert a ref/ dir to an ali/ dir (tokens must partition frames)"""
    parser = argparse.ArgumentParser(
        description=torch_token_data_dir_to_torch_ali_data_dir.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "ref_dir",
        type=_as_dir,
        help="The token sequence data directory (input)",
    )
    parser.add_argument(
        "ali_dir", help="The frame alignment data directory (output)"
    )
    parser.add_argument(
        "--feat-dir",
        default=None,
        help="The feature data directory; if given, frame counts are "
        "validated against the features",
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--num-workers")
    _add_common_arg(parser, "--mp-chunk-size")
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    basenames = (
        x
        for x in sorted(os.listdir(options.ref_dir))
        if x.startswith(options.file_prefix)
        and x.endswith(options.file_suffix)
    )
    os.makedirs(options.ali_dir, exist_ok=True)
    _multiprocessor_pattern(
        basenames,
        options,
        _token_dir_to_ali_dir_do_work,
        options.ref_dir,
        options.ali_dir,
        options.feat_dir,
    )
    return 0


def _ali_dir_to_token_dir_do_work(basename, ali_dir, ref_dir):
    ali = load_tensor(os.path.join(ali_dir, basename)).numpy()
    if len(ali):
        change = np.nonzero(np.diff(ali))[0]
        starts = np.concatenate([[0], change + 1])
        ends = np.concatenate([change + 1, [len(ali)]])
        toks = ali[starts]
        ref = np.stack([toks, starts, ends], -1).astype(np.int64)
    else:
        ref = np.zeros((0, 3), np.int64)
    save_tensor(ref, os.path.join(ref_dir, basename))


def torch_ali_data_dir_to_torch_token_data_dir(
    args: Optional[Sequence[str]] = None,
):
    """Convert an ali/ dir to a ref/ dir (segments from contiguous labels)"""
    parser = argparse.ArgumentParser(
        description=torch_ali_data_dir_to_torch_token_data_dir.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "ali_dir",
        type=_as_dir,
        help="The frame alignment data directory (input)",
    )
    parser.add_argument(
        "ref_dir", help="The token sequence data directory (output)"
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--num-workers")
    _add_common_arg(parser, "--mp-chunk-size")
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    basenames = (
        x
        for x in sorted(os.listdir(options.ali_dir))
        if x.startswith(options.file_prefix)
        and x.endswith(options.file_suffix)
    )
    os.makedirs(options.ref_dir, exist_ok=True)
    _multiprocessor_pattern(
        basenames,
        options,
        _ali_dir_to_token_dir_do_work,
        options.ali_dir,
        options.ref_dir,
    )
    return 0


def torch_logit_data_dir_to_torch_ali_data_dir(
    args: Optional[Sequence[str]] = None,
):
    """CTC-force-align a logit dir against a ref dir, writing an ali dir

Each "<file-prefix><utt><file-suffix>" in "logit_dir" stores a float tensor
of shape "(T, V)" (frame-wise CTC logits, or probabilities with
"--is-probs"); the like-named file in "ref_dir" stores the token sequence
(segment info in "(R, 3)" files is ignored; column 0 is used). The command
writes the Viterbi CTC alignment — the most probable frame-level labelling
(token ids and blanks) collapsing to the reference — as a long tensor of
shape "(T,)" to "ali_dir". Where
"torch-token-data-dir-to-torch-ali-data-dir" needs segment boundaries
already present, this derives them from a CTC model's outputs.

Utterances are padded into shape buckets (as the JAX package pads them)
and aligned on --device (default: cuda) in batches."""
    parser = argparse.ArgumentParser(
        description=torch_logit_data_dir_to_torch_ali_data_dir.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "logit_dir", type=_as_dir, help="The logit data directory (input)"
    )
    parser.add_argument(
        "ref_dir",
        type=_as_dir,
        help="The token sequence data directory (input)",
    )
    parser.add_argument(
        "ali_dir", help="The frame alignment data directory (output)"
    )
    parser.add_argument(
        "--blank-idx",
        type=int,
        default=-1,
        help="The index of the blank label in the logits' vocab dimension",
    )
    parser.add_argument(
        "--is-probs",
        action="store_true",
        default=False,
        help="Logit files store probabilities, not logits",
    )
    parser.add_argument(
        "--batch-size",
        type=int,
        default=32,
        help="Utterances aligned per device batch",
    )
    parser.add_argument(
        "--quiet",
        action="store_true",
        default=False,
        help="Suppress warnings about infeasible alignments",
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--device")
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    from .ops.decoding import ctc_forced_align

    device = default_device(options.device)

    basenames = sorted(
        x
        for x in os.listdir(options.logit_dir)
        if x.startswith(options.file_prefix)
        and x.endswith(options.file_suffix)
    )
    os.makedirs(options.ali_dir, exist_ok=True)

    def bucket(n):  # next power of two, floor 32
        b = 32
        while b < n:
            b <<= 1
        return b

    # (T_bucket, U_bucket) -> [(basename, logits (T, V), tokens (U,))]
    buckets = defaultdict(list)
    V = None
    for basename in basenames:
        logits = load_tensor(os.path.join(options.logit_dir, basename)).numpy().astype(
            np.float32
        )
        if logits.ndim != 2:
            raise ValueError(
                f"logit file {basename} has shape {logits.shape}; expected "
                "(T, V)"
            )
        if V is None:
            V = logits.shape[1]
        elif logits.shape[1] != V:
            raise ValueError(
                f"logit file {basename} has vocab size {logits.shape[1]}; "
                f"expected {V}"
            )
        ref = load_tensor(os.path.join(options.ref_dir, basename)).numpy().astype(np.int64)
        tokens = ref[:, 0] if ref.ndim == 2 else ref
        buckets[(bucket(len(logits)), bucket(max(len(tokens), 1)))].append(
            (basename, logits, tokens.astype(np.int32))
        )

    for (Tb, Ub), items in sorted(buckets.items()):
        for lo in range(0, len(items), options.batch_size):
            batch = items[lo : lo + options.batch_size]
            N = len(batch)
            logits = np.zeros((N, Tb, V), np.float32)
            refs = np.zeros((N, Ub), np.int32)
            in_lens = np.empty((N,), np.int32)
            ref_lens = np.empty((N,), np.int32)
            for n, (_, lg, tk) in enumerate(batch):
                logits[n, : len(lg)] = lg
                refs[n, : len(tk)] = tk
                in_lens[n], ref_lens[n] = len(lg), len(tk)
            paths, scores = ctc_forced_align(
                torch.from_numpy(logits).to(device),
                torch.from_numpy(refs).to(device),
                torch.from_numpy(in_lens).to(device),
                torch.from_numpy(ref_lens).to(device),
                blank_idx=options.blank_idx,
                batch_first=True,
                is_probs=options.is_probs,
            )
            paths, scores = paths.cpu().numpy(), scores.cpu().numpy()
            for n, (basename, lg, tk) in enumerate(batch):
                if not options.quiet and not np.isfinite(scores[n]):
                    warnings.warn(
                        f"utterance {basename}: no alignment exists "
                        f"({len(tk)} tokens cannot fit in {len(lg)} frames); "
                        "writing the arbitrary path anyway"
                    )
                save_tensor(
                    paths[n, : len(lg)].astype(np.int64),
                    os.path.join(options.ali_dir, basename),
                )
    return 0


def _chunk_do_work(
    utt_id,
    in_feat_dir,
    in_ali_dir,
    in_ref_dir,
    file_prefix,
    file_suffix,
    policy,
    lobe_size,
    window_type,
    pad_mode,
    pad_constant,
    partial_tokens,
    retain_token_boundaries,
    quiet,
    format_utt,
    out_feat_dir,
    out_ali_dir,
    out_ref_dir,
    device,
):
    from .functional import (
        chunk_by_slices,
        chunk_token_sequences_by_slices,
        slice_spect_data,
    )

    device = torch.device(device)
    in_basename = file_prefix + utt_id + file_suffix

    def load(dir_):
        if dir_ is None:
            return None
        return load_tensor(os.path.join(dir_, in_basename))[None].to(device)

    feats, alis, refs = load(in_feat_dir), load(in_ali_dir), load(in_ref_dir)
    if refs is not None and refs.dim() == 2:
        # token-only refs carry no segment boundaries, so chunk membership
        # is undecidable; the reference CLI crashes with an opaque
        # IndexError here — fail with an actionable message instead
        raise ValueError(
            f"ref for utterance '{utt_id}' is 1-D (tokens only); chunking "
            "requires (R, 3) refs with segment boundaries to assign tokens "
            "to chunks. Regenerate refs with boundaries (e.g. from an ali "
            "dir via torch-ali-data-dir-to-torch-token-data-dir) or exclude "
            "the ref dir"
        )
    src = {"fixed": feats, "ali": alis, "ref": refs}[policy]
    slices, _ = slice_spect_data(
        src,
        policy=policy,
        window_type=window_type,
        valid_only=pad_mode is None,
        lobe_size=lobe_size,
    )
    M = slices.shape[0]
    new_utt_ids = [
        format_utt.format(utt_id=utt_id, idx=n, start=int(x[0]), end=int(x[1]))
        for (n, x) in enumerate(slices.tolist())
    ]
    if not quiet and len(set(new_utt_ids)) != M:
        warnings.warn(f"new utterance names for '{utt_id}' are not unique")
    mode = "constant" if pad_mode is None else pad_mode
    slices_d = slices.to(device)

    def chunk(x):
        return chunk_by_slices(
            x.expand((M,) + x.shape[1:]), slices_d, mode=mode, value=pad_constant
        )

    feats_c, lens = chunk(feats)
    feats_c, lens = feats_c.cpu(), lens.tolist()
    alis_c = None
    if alis is not None:
        alis_c, lens_ = chunk(alis)
        alis_c = alis_c.cpu()
        assert lens_.tolist() == lens
    refs_c = ref_lens = None
    if refs is not None:
        refs_c, ref_lens = chunk_token_sequences_by_slices(
            refs.expand((M,) + refs.shape[1:]),
            slices_d,
            partial=partial_tokens,
            retain=retain_token_boundaries,
        )
        refs_c, ref_lens = refs_c.cpu(), ref_lens.tolist()
    for n, new_utt_id in enumerate(new_utt_ids):
        out_basename = file_prefix + new_utt_id + file_suffix
        save_tensor(feats_c[n, : lens[n]], os.path.join(out_feat_dir, out_basename))
        if alis_c is not None:
            save_tensor(
                alis_c[n, : lens[n]].long(), os.path.join(out_ali_dir, out_basename)
            )
        if refs_c is not None:
            save_tensor(
                refs_c[n, : ref_lens[n]].long(), os.path.join(out_ref_dir, out_basename)
            )


def chunk_torch_spect_data_dir(args: Optional[Sequence[str]] = None):
    """Create a new SpectDataSet directory of chunks of an existing one

The slicing and chunking run on --device (default: cuda)."""
    parser = argparse.ArgumentParser(
        description=chunk_torch_spect_data_dir.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "in_dir", type=_as_dir, help="The torch data directory to chunk"
    )
    parser.add_argument(
        "out_dir", help="The torch data directory to store chunks (output)"
    )
    parser.add_argument(
        "--policy",
        default="fixed",
        choices=["fixed", "ali", "ref"],
        help="The policy for determining slices. See SliceSpectData.",
    )
    parser.add_argument(
        "--lobe-size",
        type=_as_nonnegi,
        default=0,
        help="Size of a side lobe of a slice. See SliceSpectData.",
    )
    parser.add_argument(
        "--window-type",
        default="symmetric",
        choices=["symmetric", "causal", "future"],
        help="Type of window used in slicing. See SliceSpectData.",
    )
    parser.add_argument(
        "--pad-mode",
        default=None,
        choices=["constant", "reflect", "replicate"],
        help="If specified, chunks may extend past sequence boundaries with "
        "padding; otherwise only valid slices are kept",
    )
    parser.add_argument(
        "--pad-constant",
        type=float,
        default=0.0,
        help="Constant used when padding with '--pad-mode=constant'",
    )
    parser.add_argument(
        "--partial-tokens",
        action="store_true",
        default=False,
        help="Keep reference tokens only partly overlapping a chunk",
    )
    parser.add_argument(
        "--retain-token-boundaries",
        action="store_true",
        default=False,
        help="Keep original segment boundary values in chunked refs",
    )
    parser.add_argument(
        "--quiet", action="store_true", default=False,
        help="Suppress any warnings",
    )
    parser.add_argument(
        "--format-utt",
        default=r"{utt_id}.{start:05d}.{end:05d}",
        help="Format string for chunk utterance ids. Fields: utt_id, idx, "
        "start, end",
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--feat-subdir")
    _add_common_arg(parser, "--ali-subdir")
    _add_common_arg(parser, "--ref-subdir")
    _add_common_arg(parser, "--num-workers")
    _add_common_arg(parser, "--mp-chunk-size")
    _add_common_arg(parser, "--device")
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    options.device = str(default_device(options.device))
    in_feat_dir = os.path.join(options.in_dir, options.feat_subdir)
    in_ali_dir = os.path.join(options.in_dir, options.ali_subdir)
    in_ref_dir = os.path.join(options.in_dir, options.ref_subdir)
    if not os.path.isdir(in_ali_dir):
        in_ali_dir = None
        if options.policy == "ali":
            print("--policy=ali but no ali dir", file=sys.stderr)
            return 1
    if not os.path.isdir(in_ref_dir):
        in_ref_dir = None
        if options.policy == "ref":
            print("--policy=ref but no ref dir", file=sys.stderr)
            return 1
    ds = data.SpectDataSet(
        options.in_dir,
        file_prefix=options.file_prefix,
        file_suffix=options.file_suffix,
        warn_on_missing=not options.quiet,
        feat_subdir=options.feat_subdir,
        ali_subdir=options.ali_subdir if in_ali_dir else None,
        ref_subdir=options.ref_subdir if in_ref_dir else None,
    )
    out_feat_dir = os.path.join(options.out_dir, options.feat_subdir)
    out_ali_dir = os.path.join(options.out_dir, options.ali_subdir)
    out_ref_dir = os.path.join(options.out_dir, options.ref_subdir)
    os.makedirs(out_feat_dir, exist_ok=True)
    if in_ali_dir is not None:
        os.makedirs(out_ali_dir, exist_ok=True)
    if in_ref_dir is not None:
        os.makedirs(out_ref_dir, exist_ok=True)
    _multiprocessor_pattern(
        iter(ds.utt_ids),
        options,
        _chunk_do_work,
        in_feat_dir,
        in_ali_dir,
        in_ref_dir,
        options.file_prefix,
        options.file_suffix,
        options.policy,
        options.lobe_size,
        options.window_type,
        options.pad_mode,
        options.pad_constant,
        options.partial_tokens,
        options.retain_token_boundaries,
        options.quiet,
        options.format_utt,
        out_feat_dir,
        out_ali_dir,
        out_ref_dir,
        options.device,
    )
    return 0


def subset_torch_spect_data_dir(args: Optional[Sequence[str]] = None):
    """Make a new SpectDataSet directory from a subset of another"""
    parser = argparse.ArgumentParser(
        description=subset_torch_spect_data_dir.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("src", type=_as_dir, help="The directory to extract from")
    parser.add_argument("dest", help="The directory to extract to")
    style = parser.add_mutually_exclusive_group()
    style.add_argument(
        "--copy",
        action="store_true",
        default=False,
        help="Copy extracted files (instead of hard link)",
    )
    style.add_argument(
        "--symlink",
        action="store_true",
        default=False,
        help="Symlink extracted files (instead of hard link)",
    )
    criteria = parser.add_mutually_exclusive_group(required=True)
    criteria.add_argument(
        "--utt-list", nargs="+", metavar="UTTID", default=None,
        help="Extract these utterances",
    )
    criteria.add_argument(
        "--utt-list-file", type=argparse.FileType("r"), metavar="PATH",
        default=None, help="Extract utterances listed in this file",
    )
    criteria.add_argument(
        "--first-n", type=_as_nonnegi, metavar="N", default=None,
        help="Extract this number of utterances from the start (by id)",
    )
    criteria.add_argument(
        "--first-ratio", type=_as_closed01, metavar="R", default=None,
        help="Extract this ratio of utterances from the start (by id)",
    )
    criteria.add_argument(
        "--last-n", type=_as_nonnegi, metavar="N", default=None,
        help="Extract this number of utterances from the end (by id)",
    )
    criteria.add_argument(
        "--last-ratio", type=_as_closed01, metavar="R", default=None,
        help="Extract this ratio of utterances from the end (by id)",
    )
    criteria.add_argument(
        "--shortest-n", type=_as_nonnegi, metavar="N", default=None,
        help="Extract this number of shortest utterances",
    )
    criteria.add_argument(
        "--shortest-ratio", type=_as_closed01, metavar="R", default=None,
        help="Extract this ratio of shortest utterances",
    )
    criteria.add_argument(
        "--longest-n", type=_as_nonnegi, metavar="N", default=None,
        help="Extract this number of longest utterances",
    )
    criteria.add_argument(
        "--longest-ratio", type=_as_closed01, metavar="R", default=None,
        help="Extract this ratio of longest utterances",
    )
    criteria.add_argument(
        "--rand-n", type=_as_nonnegi, metavar="N", default=None,
        help="Extract this number of utterances at random",
    )
    criteria.add_argument(
        "--rand-ratio", type=_as_closed01, metavar="R", default=None,
        help="Extract this ratio of utterances at random",
    )
    parser.add_argument(
        "--only",
        action="store_true",
        default=False,
        help="src points directly at a tensor directory (no subdirs)",
    )
    parser.add_argument(
        "--seed",
        type=int,
        default=None,
        help="Seed for random subsetting; unset is non-deterministic",
    )
    _add_common_arg(parser, "--feat-subdir")
    _add_common_arg(parser, "--ali-subdir")
    _add_common_arg(parser, "--ref-subdir")
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--num-workers")
    _add_common_arg(parser, "--mp-chunk-size")
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    if options.only:
        options.feat_subdir = options.ali_subdir = options.ref_subdir = None
        feat_dir = options.src
    else:
        feat_dir = os.path.join(options.src, options.feat_subdir)
        if not os.path.isdir(feat_dir):
            print(f"'{feat_dir}' is not a directory", file=sys.stderr)
            return 1
        if not os.path.isdir(os.path.join(options.src, options.ali_subdir)):
            options.ali_subdir = None
        if not os.path.isdir(os.path.join(options.src, options.ref_subdir)):
            options.ref_subdir = None
    fpl, fsl = len(options.file_prefix), len(options.file_suffix)
    all_utt_ids = sorted(
        x[fpl : len(x) - fsl]
        for x in os.listdir(feat_dir)
        if x.startswith(options.file_prefix)
        and x.endswith(options.file_suffix)
    )
    if any(
        x is not None
        for x in (
            options.shortest_n,
            options.shortest_ratio,
            options.longest_n,
            options.longest_ratio,
        )
    ):
        pairs = []
        for utt_id in all_utt_ids:
            x = load_tensor(
                os.path.join(
                    feat_dir,
                    options.file_prefix + utt_id + options.file_suffix,
                )
            )
            pairs.append((x.shape[0], utt_id))
        if options.shortest_n is not None or options.shortest_ratio is not None:
            pairs.sort()
        else:
            pairs.sort(key=lambda x: (-x[0], x[1]))
        all_utt_ids = [x[1] for x in pairs]
    elif options.last_n is not None or options.last_ratio is not None:
        all_utt_ids.sort(reverse=True)
    elif options.rand_n is not None or options.rand_ratio is not None:
        random.seed(options.seed)
        random.shuffle(all_utt_ids)
    if options.utt_list is not None or options.utt_list_file is not None:
        utt_set = set(all_utt_ids)
        if options.utt_list_file is not None:
            utt_ids = (x.strip() for x in options.utt_list_file)
        else:
            utt_ids = iter(options.utt_list)
        utt_ids = [x for x in utt_ids if x in utt_set]
    else:
        a = (
            0 if x is None else x
            for x in (
                options.shortest_n,
                options.longest_n,
                options.first_n,
                options.last_n,
                options.rand_n,
            )
        )
        b = (
            0 if x is None else int(len(all_utt_ids) * x)
            for x in (
                options.shortest_ratio,
                options.longest_ratio,
                options.first_ratio,
                options.last_ratio,
                options.rand_ratio,
            )
        )
        n = max(itertools.chain(a, b))
        utt_ids = all_utt_ids[:n]
    if options.copy:
        cp = shutil.copy
    elif options.symlink:
        def cp(src, dst):
            return os.symlink(os.path.abspath(src), dst)
    else:
        cp = os.link
    subdirs = (
        [None]
        if options.only
        else [
            d
            for d in (
                options.feat_subdir,
                options.ali_subdir,
                options.ref_subdir,
            )
            if d is not None
        ]
    )
    for subdir in subdirs:
        src_dir = options.src if subdir is None else os.path.join(
            options.src, subdir
        )
        dst_dir = options.dest if subdir is None else os.path.join(
            options.dest, subdir
        )
        os.makedirs(dst_dir, exist_ok=True)
        for utt_id in utt_ids:
            basename = options.file_prefix + utt_id + options.file_suffix
            src = os.path.join(src_dir, basename)
            if not os.path.exists(src):
                continue
            dst = os.path.join(dst_dir, basename)
            if os.path.exists(dst):
                os.remove(dst)
            cp(src, dst)
    return 0


def _do_mv_printing(s, ss, c, options):
    if c > 0:
        float_fmt_str = f"{{:0.0{options.precision}f}}"
        mean = s / c
        var = ss / c - mean**2
        mean = float_fmt_str.format(mean)
        if options.bessel and c == 1:
            var = "n/a"
        else:
            if options.bessel:
                var *= c / (c - 1)
            if options.std:
                var = math.sqrt(max(var, 0))
            var = float_fmt_str.format(var)
        out_str = f"{mean} ({var})\n"
    else:
        out_str = "n/a (n/a)\n"
    options.out.write(out_str)


def _ali_moments_do_work(file_name, exclude_ids):
    x = load_tensor(file_name).numpy()
    if not len(x):
        return 0, 0, 0
    change = np.nonzero(np.diff(x))[0]
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [len(x)]])
    toks = x[starts]
    lens = ends - starts
    if exclude_ids is not None:
        keep = ~np.isin(toks, exclude_ids)
        lens = lens[keep]
    return int(lens.sum()), int((lens.astype(np.int64) ** 2).sum()), len(lens)


def print_torch_ali_data_dir_length_moments(
    args: Optional[Sequence[str]] = None,
):
    """Compute the mean and variance of segment lengths from an ali dir"""
    parser = argparse.ArgumentParser(
        description=print_torch_ali_data_dir_length_moments.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("dir", type=_as_dir, help="The ali/ dir (input)")
    parser.add_argument(
        "out",
        nargs="?",
        type=argparse.FileType("w"),
        default=sys.stdout,
        help="Where to print statistics. Defaults to stdout",
    )
    parser.add_argument(
        "--precision",
        type=_as_nonnegi,
        default=config.DEFT_FLOAT_PRINT_PRECISION,
        help="Precision with which to print stats",
    )
    parser.add_argument(
        "--bessel", action="store_true", default=False,
        help="Perform Bessel correction on the variance estimate",
    )
    parser.add_argument(
        "--std", action="store_true", default=False,
        help="Print standard deviation instead of variance",
    )
    parser.add_argument(
        "--exclude-ids",
        type=int,
        nargs="+",
        default=None,
        help="Exclude segments with these ids from the counts",
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--num-workers")
    _add_common_arg(parser, "--mp-chunk-size")
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    filenames = (
        os.path.join(options.dir, x)
        for x in sorted(os.listdir(options.dir))
        if x.startswith(options.file_prefix)
        and x.endswith(options.file_suffix)
    )
    exclude_ids = (
        np.asarray(sorted(set(options.exclude_ids)))
        if options.exclude_ids is not None
        else None
    )
    s = ss = c = 0
    for s_, ss_, c_ in _multiprocessor_pattern_generator(
        filenames, options, _ali_moments_do_work, exclude_ids
    ):
        s, ss, c = s + s_, ss + ss_, c + c_
    _do_mv_printing(s, ss, c, options)
    return 0


def _ref_moments_do_work(file_name, exclude_ids):
    ref = load_tensor(file_name).numpy()
    if ref.ndim != 2 or ref.shape[1] != 3:
        return (
            0,
            0,
            0,
            f"'{file_name}': expected tensor of shape '(R, 3)'; got "
            f"'{ref.shape}'",
        )
    lens = ref[:, 2] - ref[:, 1]
    valid = (0 <= ref[:, 1]) & (ref[:, 1] <= ref[:, 2])
    if exclude_ids is not None:
        not_excluded = ~np.isin(ref[:, 0], exclude_ids)
    else:
        not_excluded = np.ones_like(valid)
    if (~valid & not_excluded).sum() != 0:
        idxs = np.nonzero(~valid & not_excluded)[0].tolist()
        err_msg = f"'{file_name}': segments {idxs} are invalid or missing"
    else:
        err_msg = None
    lens = lens[valid & not_excluded]
    return (
        int(lens.sum()),
        int((lens.astype(np.int64) ** 2).sum()),
        len(lens),
        err_msg,
    )


def print_torch_ref_data_dir_length_moments(
    args: Optional[Sequence[str]] = None,
):
    """Compute the mean and variance of segment lengths from a ref dir"""
    parser = argparse.ArgumentParser(
        description=print_torch_ref_data_dir_length_moments.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("dir", type=_as_dir, help="The ref/ dir (input)")
    parser.add_argument(
        "out",
        nargs="?",
        type=argparse.FileType("w"),
        default=sys.stdout,
        help="Where to print statistics. Defaults to stdout",
    )
    err_grp = parser.add_mutually_exclusive_group()
    err_grp.add_argument(
        "--strict", action="store_true", default=False,
        help="Error on invalid or missing segments (default: warn)",
    )
    err_grp.add_argument(
        "--quiet", action="store_true", default=False,
        help="Suppress warnings about invalid or missing segments",
    )
    parser.add_argument(
        "--precision",
        type=_as_nonnegi,
        default=config.DEFT_FLOAT_PRINT_PRECISION,
        help="Precision with which to print stats",
    )
    parser.add_argument(
        "--bessel", action="store_true", default=False,
        help="Perform Bessel correction on the variance estimate",
    )
    parser.add_argument(
        "--std", action="store_true", default=False,
        help="Print standard deviation instead of variance",
    )
    parser.add_argument(
        "--exclude-ids",
        type=int,
        nargs="+",
        default=None,
        help="Exclude segments with these token ids from the counts",
    )
    _add_common_arg(parser, "--file-prefix")
    _add_common_arg(parser, "--file-suffix")
    _add_common_arg(parser, "--num-workers")
    _add_common_arg(parser, "--mp-chunk-size")
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    filenames = (
        os.path.join(options.dir, x)
        for x in sorted(os.listdir(options.dir))
        if x.startswith(options.file_prefix)
        and x.endswith(options.file_suffix)
    )
    exclude_ids = (
        np.asarray(sorted(set(options.exclude_ids)))
        if options.exclude_ids is not None
        else None
    )
    s = ss = c = 0
    for s_, ss_, c_, err_msg in _multiprocessor_pattern_generator(
        filenames, options, _ref_moments_do_work, exclude_ids
    ):
        if err_msg is not None:
            if options.strict:
                raise ValueError(err_msg)
            elif not options.quiet:
                warnings.warn(err_msg)
        s, ss, c = s + s_, ss + ss_, c + c_
    _do_mv_printing(s, ss, c, options)
    return 0


def arpa_lm_to_state_dict(args: Optional[Sequence[str]] = None):
    """Compile an ARPA file into a LookupLanguageModel state dict

    Builds the lookup tables (dense/hashed context tables, CSR children) of
    :class:`pydrobert_tpu_torch.lm.LookupLanguageModel` on --device
    (default: cuda) and writes their host arrays to a ``.npz`` archive, so
    decoding jobs restore with ``load_state_dict`` instead of re-parsing the
    ARPA file. The archive loads in either package."""
    parser = argparse.ArgumentParser(
        description=arpa_lm_to_state_dict.__doc__.split("\n")[0]
    )
    parser.add_argument(
        "arpa",
        type=argparse.FileType("r"),
        help="Path to the ARPA language model file ('-' for stdin)",
    )
    parser.add_argument(
        "token2id",
        type=argparse.FileType("r"),
        help="A file mapping tokens to ids: one '<token> <id>' pair per line",
    )
    parser.add_argument("out", help="Path to write the .npz state dict to")
    parser.add_argument(
        "--sos",
        default=None,
        help="Start-of-sequence token: a symbol in token2id or an integer "
        "id. Defaults to '<s>' if present, else vocab-size",
    )
    parser.add_argument(
        "--vocab-size",
        type=_as_nat,
        default=None,
        help="Number of regular token ids. Defaults to one more than the "
        "largest non-sos id in token2id",
    )
    parser.add_argument(
        "--keep-base-10",
        action="store_true",
        default=False,
        help="Store base-10 log-probabilities instead of converting to "
        "base e",
    )
    parser.add_argument(
        "--swap",
        action="store_true",
        default=False,
        help="token2id lines are '<id> <token>' instead",
    )
    _add_common_arg(parser, "--device")
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    from .lm import LookupLanguageModel

    token2id = _parse_token2id(options.token2id, options.swap, options.swap)
    if options.sos is None:
        sos = token2id.get("<s>")
    elif options.sos in token2id:
        sos = token2id[options.sos]
    else:
        try:
            sos = int(options.sos)
        except ValueError:
            print(
                f"--sos '{options.sos}' is neither a token in token2id nor "
                "an integer id",
                file=sys.stderr,
            )
            return 1
    if options.vocab_size is not None:
        vocab_size = options.vocab_size
    else:
        non_sos = [v for v in token2id.values() if v != sos]
        if not non_sos:
            print("token2id contains no non-sos ids", file=sys.stderr)
            return 1
        vocab_size = max(non_sos) + 1
    if sos is None:
        sos = vocab_size
    prob_dicts = data.parse_arpa_lm(
        options.arpa, token2id, to_base_e=not options.keep_base_10
    )
    lm = LookupLanguageModel(
        vocab_size, sos=sos, prob_dicts=prob_dicts, destructive=True,
        device=options.device,
    )
    # write through a file handle: np.savez given a PATH silently appends
    # .npz, so the archive would land somewhere other than what was passed
    with open(options.out, "wb") as f:
        np.savez(f, **lm.state_dict())
    return 0


def print_arpa_lm_state_dict_info(args: Optional[Sequence[str]] = None):
    """Summarize a compiled LookupLanguageModel state dict

    Prints '<key> <value>' lines describing an ``.npz`` state dict written
    by ``arpa-lm-to-state-dict``."""
    parser = argparse.ArgumentParser(
        description=print_arpa_lm_state_dict_info.__doc__.split("\n")[0]
    )
    parser.add_argument("state_dict", help="Path to the .npz state dict")
    parser.add_argument(
        "out_file",
        nargs="?",
        type=argparse.FileType("w"),
        default=sys.stdout,
        help="Where to write the info to. Defaults to stdout",
    )
    try:
        options = parser.parse_args(args)
    except SystemExit as ex:
        return ex.code
    from .lm import _EMPTY_KEY

    # everything needed is in the raw arrays: no device-table rebuild
    d = dict(np.load(options.state_dict))
    vocab_size, sos_, max_ngram = (int(x) for x in d["meta"])
    info = OrderedDict()
    info["vocab_size"] = vocab_size
    info["sos"] = sos_
    info["max_ngram"] = max_ngram
    max_corrections = 0
    info["num_unigrams"] = int(np.isfinite(d["uni_logp"]).sum())
    total_bytes = sum(v.nbytes for v in d.values())
    for i in range(max_ngram - 1):
        order = i + 2
        keys = d[f"ctx{i}_keys"]
        max_probe, max_children = (int(x) for x in d[f"ctx{i}_meta"])
        max_corrections += max_children
        info[f"order{order}_contexts"] = int((keys[:, 0] != _EMPTY_KEY).sum())
        info[f"order{order}_continuations"] = len(d[f"ctx{i}_tok"])
        info[f"order{order}_max_children"] = max_children
        info[f"order{order}_max_probe"] = max_probe
    info["max_corrections"] = max_corrections
    info["total_bytes"] = total_bytes
    for key, value in info.items():
        options.out_file.write(f"{key} {value}\n")
    if options.out_file != sys.stdout:
        options.out_file.close()
    return 0


def _commands():
    return {name: globals()[name] for name in __all__}


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Dispatch ``argv[0]`` (a command name, dashes or underscores) on the
    remaining arguments; returns its exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = _commands()
    if not argv or argv[0].replace("-", "_") not in commands:
        names = ", ".join(sorted(n.replace("_", "-") for n in commands))
        print(f"usage: python -m pydrobert_tpu_torch.command_line <command> ...\n"
              f"commands: {names}", file=sys.stderr)
        return 2
    return commands[argv[0].replace("-", "_")](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
