"""System/process load measurement from /proc.

Re-design of the reference's LoadTracker
(/root/reference/src/flame/utils/load_tracker.h:83-400): CPU utilization
(system-wide and per-process, from /proc/stat and /proc/<pid>/stat) and
memory/swap usage (from /proc/meminfo and /proc/<pid>/status). Pure-host
observability, plus the device-side addition: device memory stats via
jax.local_devices()[0].memory_stats() when the backend exposes them.
"""

import os
from typing import Dict, NamedTuple, Optional


class CPULoad(NamedTuple):
    total_pct: float  # system CPU utilization since last call
    process_pct: float  # this process's share


class MemLoad(NamedTuple):
    sys_total_kb: int
    sys_free_kb: int
    sys_swap_total_kb: int
    sys_swap_free_kb: int
    process_rss_kb: int
    process_swap_kb: int


class LoadTracker:
    """Stateful tracker; each get() reports utilization since the last."""

    def __init__(self, pid: Optional[int] = None):
        self.pid = pid or os.getpid()
        self._last_total = None
        self._last_idle = None
        self._last_proc = None

    def _read_stat(self):
        with open("/proc/stat") as f:
            parts = f.readline().split()[1:]
        vals = [int(v) for v in parts]
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
        # Sum only the first 8 fields: guest/guest_nice (9/10) are
        # already folded into user/nice by the kernel; including them
        # double-counts guest time and under-reports utilization on
        # virtualized hosts.
        return sum(vals[:8]), idle

    def _read_proc_stat(self):
        with open(f"/proc/{self.pid}/stat") as f:
            parts = f.read().rsplit(")", 1)[1].split()
        # utime + stime are fields 14,15 (1-indexed); after ')' they are
        # at offsets 11,12 of the remainder.
        return int(parts[11]) + int(parts[12])

    def cpu(self) -> CPULoad:
        total, idle = self._read_stat()
        proc = self._read_proc_stat()
        if self._last_total is None:
            self._last_total, self._last_idle, self._last_proc = \
                total, idle, proc
            return CPULoad(0.0, 0.0)
        dt = max(total - self._last_total, 1)
        didle = idle - self._last_idle
        dproc = proc - self._last_proc
        self._last_total, self._last_idle, self._last_proc = total, idle, proc
        return CPULoad(total_pct=100.0 * (dt - didle) / dt,
                       process_pct=100.0 * dproc / dt)

    def mem(self) -> MemLoad:
        info: Dict[str, int] = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                info[k] = int(v.strip().split()[0])
        rss = swap = 0
        with open(f"/proc/{self.pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1])
                elif line.startswith("VmSwap:"):
                    swap = int(line.split()[1])
        return MemLoad(
            sys_total_kb=info.get("MemTotal", 0),
            sys_free_kb=info.get("MemAvailable", info.get("MemFree", 0)),
            sys_swap_total_kb=info.get("SwapTotal", 0),
            sys_swap_free_kb=info.get("SwapFree", 0),
            process_rss_kb=rss, process_swap_kb=swap)

    def device_memory(self) -> Optional[Dict[str, int]]:
        """Accelerator memory stats, when the backend exposes them."""
        try:
            import jax
            stats = jax.local_devices()[0].memory_stats()
            return dict(stats) if stats else None
        except Exception:
            return None

    def get(self) -> Dict[str, float]:
        cpu = self.cpu()
        mem = self.mem()
        out = {
            "cpu_total_pct": cpu.total_pct,
            "cpu_process_pct": cpu.process_pct,
            "mem_sys_used_kb": mem.sys_total_kb - mem.sys_free_kb,
            "mem_sys_total_kb": mem.sys_total_kb,
            "mem_process_rss_kb": mem.process_rss_kb,
            "swap_used_kb": mem.sys_swap_total_kb - mem.sys_swap_free_kb,
        }
        dm = self.device_memory()
        if dm:
            for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
                if k in dm:
                    out[f"device_{k}"] = dm[k]
        return out
