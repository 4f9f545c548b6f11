"""The split-K workspace that both mpGeMM templates share.

A launch whose plan splits K across blocks meets in a zeroed int32
workspace (at least N*M entries) and zeroed arrival counters (at least one
per output tile); the kernel's last block of each tile writes the output
and returns its entries and its counter to 0, so the next launch finds them
clean. One pair per device serves every launch of the decode and the
vector-LUT kernels, so two such launches must not run at once on two
streams; nothing enforces that.
"""
from __future__ import annotations

import torch

#: device → (workspace, counters): zeroed int32, left zeroed by every launch
_WORKSPACE: dict = {}
#: workspaces outgrown by a larger call; kept alive because a CUDA graph
#: captured earlier may still point at them
_RETIRED: list = []


def launch_args(plan, device: torch.device):
    """(workspace, counters) of a launch whose plan splits K, else (None,
    None): zeroed int32, at least N*M entries and one counter per output
    tile (`plan` has m, n, splits, m_tiles and n_tiles). Grown only by an
    eager call: a first allocation inside a CUDA-graph capture would come
    from the graph's private pool, so it raises there instead."""
    if plan.splits == 1:
        return None, None
    entries, counters = plan.m * plan.n, plan.m_tiles * plan.n_tiles
    cur = _WORKSPACE.get(device)
    if cur is None or cur[0].numel() < entries or cur[1].numel() < counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "mpGeMM split-K workspace too small inside a CUDA-graph capture: "
                f"call the kernel once eagerly at (M, N) = ({plan.m}, {plan.n}) first")
        old_ws, old_cnt = cur if cur is not None else (None, None)
        cur = (torch.zeros(max(entries, 0 if old_ws is None else old_ws.numel()),
                           dtype=torch.int32, device=device),
               torch.zeros(max(counters, 0 if old_cnt is None else old_cnt.numel()),
                           dtype=torch.int32, device=device))
        if old_ws is not None:
            _RETIRED.append((old_ws, old_cnt))
        _WORKSPACE[device] = cur
    return cur
