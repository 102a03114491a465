"""Run the reference network over a batch of streams.

Delivery is dense: the spikes of the step before, and on the board those
of the steps before that, times the connectivity of each arrival delay,
plus the external tag activity times what each (cluster, tag) drives. The
counters follow the same spikes: the AER queue's overflow, and on the board
the SRAM entries routed, their mesh hops and each chip-to-chip link's
overflow. Products of float32 run with TF32 off.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from perfbench.reference import neuron
from perfbench.reference.table_v import N_SYN, Network

# columns of the per-stream route counts, summed over a stream's steps
ROUTE_COLUMNS = ("queue_dropped", "link_dropped", "delivered", "hops")


@dataclasses.dataclass
class Outcome:
    counts: torch.Tensor  # [B, n_out] output spikes per neuron, float32
    route: torch.Tensor  # [B, 4] ROUTE_COLUMNS, float32
    state: neuron.State  # after the last step
    lossy: bool  # a queue or link overflowed: which events were lost is not modelled


@contextlib.contextmanager
def exact_float32():
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = cuda, cudnn


def simulate(net: Network, params: dict, activity: torch.Tensor, dtype=torch.float32,
             rows: int = 4096) -> Outcome:
    """``activity [T, B, nc, K]`` through the network, ``rows`` streams at a
    time, with state and products in ``dtype``; ``net`` already lies on
    ``activity``'s device in that type (``Network.to``)."""
    dev = activity.device
    n, nc, cs = net.layout.n, net.n_clusters, net.cluster_size
    o0, o1 = net.layout.out
    decay, ws = neuron.synapse_constants(params, dtype, dev)
    counts, route, states, lossy = [], [], [], False
    with exact_float32():
        for r0 in range(0, activity.shape[1], rows):
            act = activity[:, r0:r0 + rows]
            b = act.shape[1]
            state = neuron.rest(params, (b, n), dtype, dev)
            history = [torch.zeros((b, n), dtype=dtype, device=dev) for _ in net.w_int]
            cnt = torch.zeros((b, o1 - o0), dtype=torch.float32, device=dev)
            rt = torch.zeros((b, len(ROUTE_COLUMNS)), dtype=torch.float32, device=dev)
            for t in range(act.shape[0]):
                drive = torch.einsum("bck,ckm->bcm", act[t].to(dtype), net.w_ext)
                drive = drive.reshape(b, n * N_SYN)
                for w, spikes in zip(net.w_int, history):
                    drive = drive + spikes @ w
                prev = history[0].float()
                over = (prev.sum(-1) - net.queue_capacity).clamp(min=0)
                rt[:, 0] += over
                if net.link_capacity is not None:
                    links = prev @ net.link_entries.float()
                    link_over = (links - net.link_capacity).clamp(min=0).sum(-1)
                    rt[:, 1] += link_over
                    rt[:, 2] += prev @ net.entries.float()
                    rt[:, 3] += prev @ net.hops.float()
                state, spikes = neuron.step(state, drive.reshape(b, n, N_SYN), params, decay, ws)
                history = [spikes, *history[:-1]]
                cnt += spikes[:, o0:o1].float()
            lossy = lossy or bool((rt[:, :2] > 0).any())
            counts.append(cnt)
            route.append(rt)
            states.append(state)
    joined = neuron.State(**{f.name: torch.cat([getattr(s, f.name) for s in states])
                             for f in dataclasses.fields(neuron.State)})
    return Outcome(torch.cat(counts), torch.cat(route), joined, lossy)
