"""Plain PyTorch version of fused event-sparse delivery.

Stage 1 from the queue, plus external activity, then stage 2:

    A[..., c, k]     = ext[..., c, k] + sum_{queued (src, w)} sum_e
                       w * [src_dest[src, e] == c] * [src_tag[src, e] == k]
    drive[..., n, t] = sum_s A[..., cluster_of(n), cam_tag[n, s]] * [cam_syn[n, s] == t]

It IS ``core.two_stage.stage1_route_events`` followed by
``stage2_cam_match``.
"""

from __future__ import annotations

import torch

from repro_torch.core.two_stage import EventQueue, stage1_route_events, stage2_cam_match


def fused_deliver_ref(
    queue: EventQueue,  # src/weight [..., Q]
    src_tag: torch.Tensor,  # [N, E] int32, -1 empty
    src_dest: torch.Tensor,  # [N, E] int32
    cam_tag: torch.Tensor,  # [N, S] int32, -1 empty
    cam_syn: torch.Tensor,  # [N, S] int32 in [0, 4)
    cluster_size: int,
    k_tags: int,
    external_activity: torch.Tensor | None = None,  # [..., n_clusters, K]
    syn_onehot: torch.Tensor | None = None,  # [N, S, 4] per-table constant
) -> torch.Tensor:  # [..., N, 4]
    n = src_tag.shape[0]
    a = stage1_route_events(queue, src_tag, src_dest, n // cluster_size, k_tags)
    if external_activity is not None:
        a = a + external_activity
    return stage2_cam_match(a, cam_tag, cam_syn, cluster_size, syn_onehot)
