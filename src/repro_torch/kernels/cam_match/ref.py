"""Plain PyTorch version of the stage-2 CAM match.

For every neuron ``n`` in cluster ``c`` and every CAM word ``s``:

    drive[..., n, t] = sum_s activity[..., c, cam_tag[n, s]] * [cam_syn[n, s] == t]

with empty words (``cam_tag < 0``) contributing nothing. It IS
``core.two_stage.stage2_cam_match``, re-exported under the kernel's name.
"""

from __future__ import annotations

import torch

from repro_torch.core.two_stage import stage2_cam_match


def cam_match_ref(
    activity: torch.Tensor,  # [..., n_clusters, K] float
    cam_tag: torch.Tensor,  # [N, S] int32, -1 empty
    cam_syn: torch.Tensor,  # [N, S] int32 in [0, 4)
    cluster_size: int,
) -> torch.Tensor:  # [..., N, 4]
    return stage2_cam_match(activity, cam_tag, cam_syn, cluster_size)
