"""Console commands for SpectDataSet directories and scoring (counterpart
of :mod:`pydrobert_tpu.command_line`; ``get-torch-spect-data-dir-info`` and
``compute-torch-token-data-dir-error-rates`` so far).

Each command is a function of an argument list that returns an exit code,
with the JAX package's flags and file formats. Run one as::

    python -m pydrobert_tpu_torch.command_line <command> [args ...]

where ``<command>`` is the function's name with dashes
(``compute-torch-token-data-dir-error-rates``) or underscores. Error rates
run through :func:`pydrobert_tpu_torch.ops.string.error_rate` on ``--device``
(``cuda`` by default), so each ``--batch-size`` batch of uniform-cost rates
is one launch of the edit-distance kernel on a card.
"""

import argparse
import os
import sys
import warnings
from collections import OrderedDict, defaultdict
from typing import Optional, Sequence

import numpy as np
import torch

from . import config, data, default_device
from .data.datasets import _info_and_validate
from .utils.serial import load_tensor

__all__ = [
    "compute_torch_token_data_dir_error_rates",
    "get_torch_spect_data_dir_info",
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
    "id2token": {
        "type": argparse.FileType("r"),
        "help": "ID-to-token mapping file, one entry per line in the "
        'format "<id> <token>" (tokens are e.g. words or phones). Pass '
        '"--swap" if the file lists "<token> <id>" instead',
    },
    "--swap": {
        "action": "store_true",
        "default": False,
        "help": "Read the token/id mapping file with its two columns in "
        "the opposite order",
    },
    "--feat-subdir": {
        "default": config.DEFT_FEAT_SUBDIR,
        "help": "Subdirectory of the data dir holding feature tensors",
    },
    "--ali-subdir": {
        "default": config.DEFT_ALI_SUBDIR,
        "help": "Subdirectory of the data dir holding per-frame alignments",
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
