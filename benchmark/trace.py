"""What a torch.profiler trace of the slice says: device busy time (the
union of the intervals in which an operation ran on the device), kernel
launches, the device time of named kernels, the operations that took
most device time, and the idle gaps between them by what the host was
doing.  The union arithmetic is lightgbm_tpu_torch/trace_main.py's."""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

# device activities that are copies or fills, not kernel launches
_NOT_LAUNCHES = ("Memcpy", "Memset", "memcpy", "memset")


def union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@dataclass
class Trace:
    device: List[Tuple[str, float, float]]   # (name, start us, end us)
    host: List[Tuple[str, float, float]]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in prof.events():
            iv = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == DeviceType.CUDA:
                dev.append(iv)
            elif e.device_type == DeviceType.CPU:
                host.append(iv)
        return cls(dev, host)

    @property
    def busy_s(self) -> float:
        return union_us([(a, b) for _, a, b in self.device]) * 1e-6

    @property
    def launches(self) -> int:
        return sum(1 for n, _, _ in self.device
                   if not n.startswith(_NOT_LAUNCHES))

    def kernel_s(self, names: Sequence[str]) -> float:
        """Device seconds of the kernels whose name holds one of `names`."""
        return sum(b - a for n, a, b in self.device
                   if any(k in n for k in names)) * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for n, a, b in self.device:
            tot[n[:120]] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Seconds of device idleness between the first and last device
        activity, summed by the innermost host operation open at each
        gap's midpoint ("host: no operation" where none is)."""
        ivs = sorted((a, b) for _, a, b in self.device)
        gaps, end = [], None
        for a, b in ivs:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        host = sorted(self.host, key=lambda x: x[1])
        starts = [h[1] for h in host]
        tot: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            m = (a + b) / 2
            i = bisect.bisect_right(starts, m) - 1
            label = "host: no operation"
            # the latest-starting open operation is the innermost one
            for j in range(i, max(i - 512, -1), -1):
                if host[j][2] >= m:
                    label = host[j][0][:120]
                    break
            tot[label] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])
                [:top]]
