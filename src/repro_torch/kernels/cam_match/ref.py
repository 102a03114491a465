"""Plain PyTorch version of the stage-2 CAM match.

For every neuron ``n`` in cluster ``c`` and every CAM word ``s``:

    drive[..., n, t] = sum_s activity[..., c, cam_tag[n, s]] * [cam_syn[n, s] == t]

with empty words (``cam_tag < 0``) contributing nothing. It IS
``core.two_stage.stage2_cam_match``, re-exported under the kernel's name.

:func:`cam_counts` turns the CAM tables into the per-cluster count matrix
that makes the same function one batched matrix product,
``drive = torch.bmm(activity.transpose(0, 1), counts)`` (up to the layout of
the output). Nothing on the serving path calls it: it is the library
yardstick ``chip_smoke.py`` times beside the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.two_stage import N_SYN_TYPES, stage2_cam_match


def cam_match_ref(
    activity: torch.Tensor,  # [..., n_clusters, K] float
    cam_tag: torch.Tensor,  # [N, S] int32, -1 empty
    cam_syn: torch.Tensor,  # [N, S] int32 in [0, 4)
    cluster_size: int,
) -> torch.Tensor:  # [..., N, 4]
    return stage2_cam_match(activity, cam_tag, cam_syn, cluster_size)


def cam_counts(
    cam_tag: torch.Tensor,  # [N, S] int32, -1 empty
    cam_syn: torch.Tensor,  # [N, S] int32
    n_clusters: int,
    k_tags: int,
) -> torch.Tensor:  # [n_clusters, K, cluster_size * 4] float32
    """``C[c, k, j * 4 + t]``: the CAM words of neuron ``j`` of cluster ``c``
    whose tag, clamped into ``[0, K)``, is ``k`` and whose type is ``t``.
    Empty words and types outside ``[0, 4)`` are not counted, as the plain
    version adds nothing for them. Then, for ``activity [B, nc, K]``,
    ``torch.bmm(activity.transpose(0, 1), C)`` is ``[nc, B, cluster_size * 4]``,
    the drive of :func:`cam_match_ref` with clusters first."""
    n, _ = cam_tag.shape
    cluster_size = n // n_clusters
    if n != n_clusters * cluster_size:
        raise ValueError(f"cam_tag has {n} rows, not {n_clusters} clusters of equal size")
    counted = (cam_tag >= 0) & (cam_syn >= 0) & (cam_syn < N_SYN_TYPES)
    neuron = torch.arange(n, dtype=torch.int64, device=cam_tag.device)[:, None]
    cluster, j = neuron // cluster_size, neuron % cluster_size
    width = cluster_size * N_SYN_TYPES
    cell = ((cluster * k_tags + cam_tag.clamp(0, k_tags - 1)) * width
            + j * N_SYN_TYPES + cam_syn.clamp(0, N_SYN_TYPES - 1))
    counts = torch.bincount(cell[counted], minlength=n_clusters * k_tags * width)
    return counts.to(torch.float32).view(n_clusters, k_tags, width)
