"""The profiler's records of a traced window, in the forms the per-layer
metrics read: device kernels (name, start, end), the host's launch calls
and its named ranges (the benchmark's ``portbench.<unit>`` spans around
each call into the port, and the port's ``pydt.loop/<loop>`` trip ranges),
all in nanoseconds on the trace's clock."""

import bisect
from typing import List, Optional, Tuple

RANGE_PREFIXES = ("portbench.", "pydt.loop/")


def union_ns(intervals, lo=None, hi=None) -> int:
    """Length of the union of ``(start, end)`` intervals, clipped to ``[lo, hi]``."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Records:
    def __init__(self, prof, unit_span: str):
        from torch.autograd import DeviceType

        self.kernels: List[Tuple[int, int, str, int]] = []  # start, end, name, corr
        self.launches: List[Tuple[int, int]] = []  # start, corr
        self.ranges: List[Tuple[int, int, str]] = []
        self.host: List[Tuple[int, int, str]] = []
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns()
            end = s + e.duration_ns()
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    self.kernels.append((s, end, name, e.correlation_id()))
            elif name.startswith(RANGE_PREFIXES):
                self.ranges.append((s, end, name))
            elif "LaunchKernel" in name:
                self.launches.append((s, e.correlation_id()))
            else:
                self.host.append((s, end, name))
        self.kernels.sort()
        self.launches.sort()
        self.ranges.sort()
        self.host.sort()
        self._launch_starts = [s for s, _ in self.launches]
        self._launch_at = {c: s for s, c in self.launches}
        self.units = self.spans(unit_span)
        if not self.units:
            raise RuntimeError(f"the trace holds no {unit_span} range")
        self.lo = self.units[0][0]
        self.hi = max(e for _, e in self.units)
        # the window runs until the device finishes the last unit's work
        last = max((k[1] for k in self.kernels if k[0] < self.hi), default=self.hi)
        self.hi = max(self.hi, last)
        self.window_s = (self.hi - self.lo) / 1e9
        self.busy_s = union_ns([(k[0], k[1]) for k in self.kernels], self.lo, self.hi) / 1e9

    def spans(self, name: str) -> List[Tuple[int, int]]:
        """``(start, end)`` of every host range named ``name``."""
        return [(s, e) for s, e, n in self.ranges if n == name]

    def launches_in(self, s: int, e: int) -> int:
        """Kernel launches the host issued in ``[s, e)``."""
        return bisect.bisect_left(self._launch_starts, e) - bisect.bisect_left(
            self._launch_starts, s
        )

    def kernels_of(self, s: int, e: int, name: Optional[str] = None):
        """Kernels launched in ``[s, e)`` (by the host's launch call), whose
        name holds ``name`` when given."""
        out = []
        for k in self.kernels:
            at = self._launch_at.get(k[3])
            if at is None or not (s <= at < e):
                continue
            if name is None or name in k[2]:
                out.append(k)
        return out

    def breakdown(self, top: int = 10):
        """The device operations that took most time, and the longest idle
        gaps of the device named by the innermost host range or operator
        running when each began: ``{"device_ops": [[name, s], ...],
        "idle_gaps": [[name, s], ...]}``."""
        sums = {}
        for s, e, name, _ in self.kernels:
            if e > self.lo and s < self.hi:
                sums[name] = sums.get(name, 0) + (e - s)
        ops = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        cur = self.lo
        for s, e, _, _ in self.kernels:
            if e <= self.lo or s >= self.hi:
                continue
            if s > cur:
                gaps.append((s - cur, cur))
            cur = max(cur, e)
        if self.hi > cur:
            gaps.append((self.hi - cur, cur))
        gaps.sort(reverse=True)
        named = [[self.host_at(at + 1), g / 1e9] for g, at in gaps[:top]]
        return {
            "device_ops": [[n[:120], v / 1e9] for n, v in ops],
            "idle_gaps": named,
        }

    def host_at(self, t: int) -> str:
        """The innermost host range or operator running at ``t``."""
        best, best_len = "idle host", None
        for seq in (self.ranges, self.host):
            i = bisect.bisect_right(seq, (t, float("inf"), "")) - 1
            # walk back over earlier starts to find those still open at t
            j, seen = i, 0
            while j >= 0 and seen < 256:
                s, e, n = seq[j][:3]
                if s <= t < e and (best_len is None or e - s < best_len):
                    best, best_len = n, e - s
                j -= 1
                seen += 1
        return best[:120]
