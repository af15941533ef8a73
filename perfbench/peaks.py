"""The yardstick's table of peaks and the least time of a piece of work.

NVIDIA H100 SXM5 data sheet, dense rates, at the full 700 W power limit:
HBM3 at 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s (a fused
multiply-add counts as two operations, so the rate bounds any count of
float adds, subtracts and multiplies from above). Integer pipes from the
CUDA C++ Programming Guide's throughput table for compute capability 9.0,
per clock per SM: 64 32-bit integer adds, compares and logic operations,
16 population counts; times 132 SMs at the published 1,980 MHz boost
clock. The pipes run side by side, so the least time is the larger of the
bytes over the memory rate and the busiest pipe's operations over its
rate. A card set below 700 W (`power.limit`, recorded beside every run)
runs slower than these peaks."""

from __future__ import annotations

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_ops_per_s": 67e12,
    "sms": 132,
    "boost_clock_hz": 1.98e9,
    "alu_per_clk_sm": 64,
    "popc_per_clk_sm": 16,
}


def peaks_for(kind: str) -> dict | None:
    """The peaks of a card by the name torch.cuda.get_device_name gives;
    None for a card the table does not hold (no roofline is read then)."""
    return H100_SXM if "H100" in kind else None


def least_time_s(peaks: dict, nbytes: float, alu_ops: float = 0.0,
                 popc_ops: float = 0.0, f32_ops: float = 0.0) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations"): what bounds the work."""
    clocks = peaks["sms"] * peaks["boost_clock_hz"]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    t_ops = max(alu_ops / (peaks["alu_per_clk_sm"] * clocks),
                popc_ops / (peaks["popc_per_clk_sm"] * clocks),
                f32_ops / peaks["f32_ops_per_s"])
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
