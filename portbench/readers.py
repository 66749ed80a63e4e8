"""What the per-layer metrics share: each traced unit's span beside the
unit's own record, the port's loop trips inside a span, the parts of the
untraced units, and the model FLOPs of a unit."""

from .counts import flops
from .counts.peaks import BF16_FLOPS_PER_S

LOOP = "pydt.loop/"


def units(run):
    """``(span, unit)`` pairs of the traced window, in order."""
    if run.records is None:
        return []
    return list(zip(run.records.units, run.units))


def trips(run, span, loop):
    """``(start, end)`` of the trips of ``loop`` that lie inside ``span``."""
    s, e = span
    return [(a, b) for a, b in run.records.spans(LOOP + loop) if s <= a and b <= e]


def part_ms(run, key):
    """Mean over the untraced window's units of the part ``key`` each timed
    on the device's timeline (``enc_ms``, ``loop_ms``); None when no unit
    timed it."""
    times = [u[key] for u in run.plain_units if key in u]
    return sum(times) / len(times) if times else None


def launches_per_trip(run, loop):
    n = launched = 0
    for span, _ in units(run):
        for a, b in trips(run, span, loop):
            n += 1
            launched += run.records.launches_in(a, b)
    return launched / n if n else None


def unit_flops(run, unit):
    """Model FLOPs of a unit's work at its true lengths."""
    cfg = run.config
    lens = [int(x) for x in unit.get("lens", [])]
    if cfg["model"] == "ConformerCTC":
        return sum(flops.ctc_forward_flops(cfg, L) for L in lens)
    if "new_frames" in unit:  # a streaming call
        return sum(flops.stream_push_flops(cfg, n, 0) for n in unit["new_frames"]) + \
            flops.emission_flops(cfg, unit["tokens"])
    frames = sum(flops.out_length(L) for L in lens)
    return (sum(flops.encoder_flops(cfg, L) for L in lens)
            + len(lens) * flops.transducer_decode_flops(cfg, 0, 0)
            + frames * (flops.transducer_decode_flops(cfg, 1, 0)
                        - flops.transducer_decode_flops(cfg, 0, 0))
            + flops.emission_flops(cfg, unit["tokens"]))


def mfu(run, kinds=None):
    """Model FLOPs of the untraced window's units (of ``kinds`` when
    given) over their wall time and the bf16 peak, in percent."""
    done = secs = 0.0
    for u in run.plain_units:
        if kinds is not None and u.get("kind") not in kinds:
            continue
        done += unit_flops(run, u)
        secs += u["ms"] / 1e3
    if not secs:
        return None
    return 100.0 * done / secs / BF16_FLOPS_PER_S


def idle_share(run):
    if run.records is None:
        return None
    r = run.records
    return 100.0 * (1.0 - r.busy_s / r.window_s)
