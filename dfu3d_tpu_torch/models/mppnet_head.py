"""MPPNet's second stage, the multi-frame trajectory head (port of
dfu3d_tpu/models/mppnet_head.py; reference pcdet roi_heads/mppnet_head.py,
model_utils/mppnet_utils.py, mppnet_memory_bank_e2e.py).

    trajectory (`generate_trajectory`: each current proposal propagated a
    frame back and matched to that frame's proposals by 3D IoU, one B1
    launch per past frame) → per frame and RoI the first NUM_LIDAR_POINTS
    points of that frame inside the RoI's enlarged BEV circle
    (`crop_frame_points`) → spherical offsets to the trajectory box's
    corners and centre + the raw channels → `up_dimension_geometry` →
    ball-query max pools onto the grid_size³ proxy points of the trajectory
    box, one Dense-ReLU pair per radius → + `up_dimension_motion` of the
    proxies against the current box and the frame's timestamp → frames
    arranged into groups (`fusion_all_group`, `fusion_norm` when there are
    more frames than groups) → a token per group through the encoder
    layers (SpatialMixerBlock, token attention, inter-group fusion in every
    layer but the last) → per-layer class logits, per-group box
    regressions, the trajectory PointNet (`seqboxembed`) and the joint
    regression.

With an E2E memory bank only frame 0's geometry is computed from points;
frames 1 .. T-1 read the cached features of their matched bank entries.

The frame → group arrangement mirrors JAX's `(gi + j · stride) % T`: at 16
frames in 4 groups with stride 1 only frames 0-6 reach a group, and frames
7-15 are cropped, pooled and embedded all the same (ROADMAP Queue C).

Module names follow the flax tree (roi_head.up_dimension_geometry.fc0,
Dense_0 .. Dense_3 (the pool MLPs), layer0.mixer.mixer_x.fc1, layer0.token_attn.q,
layer1.cross_ffn2.norm_out, seqboxembed.bn3, jointembed.fc3, token, ...).
The attentions are two batched products with the softmax in fp32, as
JAX's einsums; there is no mask.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core import pointnet2 as P
from ..core.geometry.boxes import boxes_to_corners_3d, rotate_points_along_z
from ..core.geometry.iou import pairwise_iou3d
from .roi_head import dense_grid_points
from .transfusion_head import LayerNorm, _fp32_linear

PI = 3.141592653589793


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

def spherical_corner_feature(xyz, roi):
    """Offsets of points to a box's 8 corners and its centre in spherical
    coordinates: xyz (..., K, 3), roi (..., 7) → (..., K, 27), the distances
    over the box diagonal (+1e-5), then the arctan of y / (x + 1e-5), then
    the arccos of z / (distance + 1e-5) clipped to [-1, 1], 9 each."""
    corners = boxes_to_corners_3d(roi)
    anchors = torch.cat([corners, roi[..., None, :3]], dim=-2)       # (..., 9, 3)
    off = xyz[..., :, None, :] - anchors[..., None, :, :]            # (..., K, 9, 3)
    diag = torch.sqrt(roi[..., 3] * roi[..., 3] + roi[..., 4] * roi[..., 4]
                      + roi[..., 5] * roi[..., 5])
    dis = torch.sqrt(off[..., 0] * off[..., 0] + off[..., 1] * off[..., 1]
                     + off[..., 2] * off[..., 2])
    phi = torch.atan(off[..., 1] / (off[..., 0] + 1e-5))
    the = torch.acos(torch.clamp(off[..., 2] / (dis + 1e-5), -1.0, 1.0))
    dis = dis / (diag[..., None, None] + 1e-5)
    return torch.cat([dis, phi, the], dim=-1)


def proxy_points_of_roi(rois, grid_size: int):
    """The grid_size³ proxy points inside each box, x slowest and z
    fastest: rois (..., 7) → global (..., P, 3), local (..., P, 3)."""
    local = rotate_points_along_z(dense_grid_points(rois, grid_size), rois[..., 6])
    return local + rois[..., None, :3], local


def crop_frame_points(points, points_valid, frame_of, rois, roi_valid, k: int, frames: int):
    """Per frame f < `frames` and RoI, the first `k` points of frame f (in
    index order) within 1.1 half-diagonals of the RoI's centre in BEV:
    points (B, N, C), points_valid and frame_of (B, N), rois (B, F, R, 7),
    roi_valid (B, F, R) → (B, F, R, k, C) and nonempty (B, F, R). Empty
    slots repeat the first hit; a RoI with no hit (or invalid) is zeroed.

    JAX takes lax.top_k of a 0/1 mask over every point of the sample for
    each (frame, RoI), which ranks the hits lowest index first. Here each
    frame's points are first gathered in index order (one stable sort of
    the frame ids), and the hits found over that frame alone with the
    cumsum-and-searchsorted form of the ball query: the same indices over
    1/T of the points."""
    b, n, c = points.shape
    key = torch.where(points_valid, frame_of, frames)
    order = torch.argsort(key, dim=-1, stable=True)
    counts = torch.stack([(key == f).sum(-1) for f in range(frames)], dim=-1)   # (B, F)
    starts = torch.cumsum(counts, dim=-1) - counts
    width = max(int(counts.max()), 1)   # one host sync: the widest frame
    ar = torch.arange(width, device=points.device)
    radii = 1.1 * torch.sqrt((rois[..., 3] / 2) ** 2 + (rois[..., 4] / 2) ** 2)   # (B, F, R)
    rows = torch.arange(b, device=points.device)[:, None, None]
    out, nonempty = [], []
    for f in range(frames):
        inb = ar < counts[:, f, None]                                    # (B, W)
        src = torch.gather(order, 1, torch.clamp(starts[:, f, None] + ar, max=n - 1))
        xy = torch.gather(points[..., :2], 1, src[..., None].expand(-1, -1, 2))
        dx = xy[:, None, :, 0] - rois[:, f, :, None, 0]
        dy = xy[:, None, :, 1] - rois[:, f, :, None, 1]
        d = torch.sqrt(dx * dx + dy * dy)                                # (B, R, W)
        within = (d <= radii[:, f, :, None]) & inb[:, None, :] & roi_valid[:, f, :, None]
        del dx, dy, d
        idx, has = P.first_hits(within, k)                               # (B, R, k)
        idx = torch.gather(src, 1, idx.reshape(b, -1)).reshape(idx.shape)
        pts = points[rows, idx]                                          # (B, R, k, C)
        out.append(torch.where(has[..., None, None], pts, 0.0))
        nonempty.append(has)
    return torch.stack(out, dim=1), torch.stack(nonempty, dim=1)


def generate_trajectory(cur_boxes, cur_valid, proposals_list, proposals_valid,
                        iou_thresh: float = 0.5):
    """Backward trajectories: cur_boxes (B, R, C ≥ 7), each propagated one
    frame back by columns 7:9 (only when C > 8) and matched to frame f's
    proposals (B, T, Rp, C) by 3D IoU ≥ iou_thresh (first index among tied
    maxima; invalid proposals at -1): a match adopts that proposal, a miss
    keeps the propagated box. One B1 launch per past frame over the batch.
    Returns trajectory_rois (B, T, R, C) and valid_length (B, T, R)."""
    c = cur_boxes.shape[-1]
    traj, valid, prev = [cur_boxes], [cur_valid], cur_boxes
    for f in range(1, proposals_list.shape[1]):
        prop = prev
        if c > 8:
            prop = torch.cat([prev[..., 0:2] + prev[..., 7:9], prev[..., 2:]], dim=-1)
        props = proposals_list[:, f]
        iou = pairwise_iou3d(prop[..., :7], props[..., :7])             # (B, R, Rp)
        iou = torch.where(proposals_valid[:, f, None, :], iou, -1.0)
        best_iou, best = iou.max(dim=-1)
        matched = best_iou >= iou_thresh
        picked = torch.gather(props, 1, best[..., None].expand(-1, -1, c))
        prev = torch.where(matched[..., None], picked, prop)
        traj.append(prev)
        valid.append(matched & cur_valid)
    return torch.stack(traj, dim=1), torch.stack(valid, dim=1)


# --------------------------------------------------------------------------
# building blocks (mppnet_utils)
# --------------------------------------------------------------------------

class PlainMLP(nn.Module):
    """Linear/ReLU stack without norms: fc0 .. fc{n-1}, `hidden` wide, the
    last `out` wide."""

    def __init__(self, in_channels: int, hidden: int, out: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"fc{i}", nn.Linear(in_channels, out if last else hidden))
            in_channels = hidden

    def forward(self, x):
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.num_layers - 1}")(x)


class ResidualFFN(nn.Module):
    """LN(x + update) → fc1, ReLU, fc2 → LN(x + ·) (mppnet_utils.FFN)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm_in = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.norm_out = LayerNorm(dim)

    def forward(self, x, update):
        x = self.norm_in(x + update)
        return self.norm_out(x + self.fc2(torch.relu(self.fc1(x))))


class MultiHeadAttention(nn.Module):
    """q / k / v projections (flax DenseGeneral (C, H, D) as Linear), the
    query times D^-1/2, softmax over the keys in fp32, the output
    projection: q (..., Lq, C), k and v (..., Lk, C) → (..., Lq, C)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q, k, v):
        h = self.heads
        d = q.shape[-1] // h

        def split(x):   # (..., L, C) → (..., h, L, d)
            return x.unflatten(-1, (h, d)).transpose(-3, -2)

        qh = split(self.q(q) * d ** -0.5)
        vh = split(self.v(v))
        logits = qh @ split(self.k(k)).transpose(-1, -2)
        w = torch.softmax(logits.float(), dim=-1).to(vh.dtype)
        o = (w @ vh).transpose(-3, -2).flatten(-2)
        return self.out(o)


class SpatialMixerBlock(nn.Module):
    """Mixes the (g, g, g, C) proxy lattice along x (axis -2), then y (-3),
    then z (-4), each with a 3-layer MLP over the axis, a residual and a
    LayerNorm over the channels; then a channel FFN (2C → C) with its
    residual LayerNorm."""

    def __init__(self, mixer_hidden: int, grid_size: int, channels: int):
        super().__init__()
        self.grid_size = grid_size
        for nm in ("x", "y", "z"):
            self.add_module(f"mixer_{nm}", PlainMLP(grid_size, mixer_hidden, grid_size, 3))
            self.add_module(f"norm_{nm}", LayerNorm(channels))
        self.ffn1 = nn.Linear(channels, 2 * channels)
        self.ffn2 = nn.Linear(2 * channels, channels)
        self.norm_channel = LayerNorm(channels)

    def forward(self, x):
        g, c = self.grid_size, x.shape[-1]
        s = x.reshape(x.shape[:-2] + (g, g, g, c))
        for ax, nm in ((-2, "x"), (-3, "y"), (-4, "z")):
            m = getattr(self, f"mixer_{nm}")(s.movedim(ax, -1)).movedim(-1, ax)
            s = getattr(self, f"norm_{nm}")(s + m)
        s = s.reshape(x.shape)
        return self.norm_channel(s + self.ffn2(torch.relu(self.ffn1(s))))


class TrajectoryPointNet(nn.Module):
    """The box-sequence PointNet: conv0-conv3 (64, 128, 256, 512), each with
    its LayerNorm bn0-bn3 and a ReLU after all but the last, a max over
    time, fc1 (256) and fc2 (`hidden`) with ReLUs, and the center / size /
    heading regressions fc_*1 (256, ReLU) → fc_*2 (no bias): (box_reg
    (..., 7) fp32, feature (..., hidden))."""

    def __init__(self, hidden: int):
        super().__init__()
        c_in = 8
        for i, c in enumerate((64, 128, 256, 512)):
            self.add_module(f"conv{i}", nn.Linear(c_in, c))
            self.add_module(f"bn{i}", LayerNorm(c))
            c_in = c
        self.fc1 = nn.Linear(512, 256)
        self.fc2 = nn.Linear(256, hidden)
        for nm, out in (("ce", 3), ("s", 3), ("hr", 1)):
            self.add_module(f"fc_{nm}1", nn.Linear(hidden, 256))
            self.add_module(f"fc_{nm}2", nn.Linear(256, out, bias=False))

    def forward(self, box_seq):
        x = box_seq
        for i in range(4):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            if i < 3:
                x = torch.relu(x)
        x = torch.relu(self.fc1(x.amax(dim=-2)))
        feat = torch.relu(self.fc2(x))
        heads = [getattr(self, f"fc_{nm}2")(torch.relu(getattr(self, f"fc_{nm}1")(feat)))
                 for nm in ("ce", "s", "hr")]
        return torch.cat(heads, dim=-1).float(), feat


class MPPNetEncoderLayer(nn.Module):
    """One encoder layer: the mixer over each group's proxies, the group
    token attending to the mixed group (the grid position added to the keys
    only), norm1, FFN, norm2; with `inter_group`, the groups concatenated
    through `fusion_all_groups` (4 layers) and each group cross-attending
    to the fused lattice with its own `cross_attn{g}` and `cross_ffn{g}`."""

    def __init__(self, hidden: int, heads: int, ffn_hidden: int, mixer_hidden: int,
                 grid_size: int, num_groups: int, inter_group: bool):
        super().__init__()
        self.num_groups = num_groups
        self.inter_group = inter_group
        self.mixer = SpatialMixerBlock(mixer_hidden, grid_size, hidden)
        self.token_attn = MultiHeadAttention(hidden, heads)
        self.norm1 = LayerNorm(hidden)
        self.ffn1 = nn.Linear(hidden, ffn_hidden)
        self.ffn2 = nn.Linear(ffn_hidden, hidden)
        self.norm2 = LayerNorm(hidden)
        if inter_group:
            self.fusion_all_groups = PlainMLP(num_groups * hidden, hidden, hidden, 4)
            for g in range(num_groups):
                self.add_module(f"cross_attn{g}", MultiHeadAttention(hidden, heads))
                self.add_module(f"cross_ffn{g}", ResidualFFN(hidden, ffn_hidden))

    def forward(self, tok, grp, pos):
        """tok (B, R, G, 1, H); grp (B, R, G, P, H); pos (P, H)."""
        mixed = self.mixer(grp)
        tok = self.norm1(tok + self.token_attn(tok, mixed + pos, mixed))
        tok = self.norm2(tok + self.ffn2(torch.relu(self.ffn1(tok))))
        grp = mixed
        if self.inter_group:
            fused = self.fusion_all_groups(torch.cat(grp.unbind(dim=-3), dim=-1))
            key = fused + pos
            grp = torch.stack([
                getattr(self, f"cross_ffn{g}")(
                    grp[..., g, :, :],
                    getattr(self, f"cross_attn{g}")(grp[..., g, :, :] + pos, key, fused))
                for g in range(self.num_groups)], dim=-3)
        return tok, grp


# --------------------------------------------------------------------------
# the head
# --------------------------------------------------------------------------

class MPPNetHead(nn.Module):
    """The multi-frame RoI head (JAX MPPNetHead): `forward(rois, roi_valid,
    trajectory_rois, traj_valid, points, points_valid, geometry_bank=None,
    bank_valid=None)` → {rcnn_cls (B, R), cls_layers (L, B, R), rcnn_reg
    (B, R, 7), point_reg (L, G, B, R, 7), box_reg (B, R, 7), all fp32;
    geometry_memory (B, R, P, H), the next bank entry}. Points carry their
    time lag last; a point belongs to frame round(lag / frame_dt), clipped
    to [0, T - 1] (half steps round to even, in fp32, as JAX rounds)."""

    def __init__(self, num_point_features: int, num_frames: int = 4, num_groups: int = 4,
                 sequence_stride: int = 1, grid_size: int = 4, num_lidar_points: int = 128,
                 hidden: int = 64, enc_layers: int = 3, nheads: int = 4, ffn_hidden: int = 256,
                 mixer_hidden: int = 16, pool_radii: Sequence[float] = (0.8, 1.6),
                 pool_nsample: int = 16, frame_dt: float = 0.1):
        super().__init__()
        self.num_frames, self.num_groups = num_frames, num_groups
        self.sequence_stride = sequence_stride
        self.grid_size, self.num_lidar_points = grid_size, num_lidar_points
        self.hidden, self.enc_layers = hidden, enc_layers
        self.pool_radii = tuple(float(r) for r in pool_radii)
        self.pool_nsample, self.frame_dt = pool_nsample, frame_dt
        hg = hidden // len(self.pool_radii)
        self.up_dimension_geometry = PlainMLP(27 + num_point_features - 3, 64, hg, 3)
        # JAX's nn.Sequential([Dense, relu, Dense, relu]) per radius, built in
        # the head's compact method: flax names its Dense layers Dense_0 ..
        # Dense_{2 · radii - 1} in the head's own scope
        for ri in range(len(self.pool_radii)):
            self.add_module(f"Dense_{2 * ri}", nn.Linear(3 + hg, hg))
            self.add_module(f"Dense_{2 * ri + 1}", nn.Linear(hg, hg))
        self.up_dimension_motion = PlainMLP(30, 64, hidden, 3)
        if num_frames != num_groups:
            glen = num_frames // num_groups
            self.fusion_all_group = PlainMLP(glen * hidden, hidden, hidden, 4)
            self.fusion_norm = ResidualFFN(hidden, ffn_hidden)
        self.grid_pos_embeded = PlainMLP(3, 256, hidden, 2)
        self.token = nn.Parameter(torch.zeros(num_groups, 1, hidden))
        for li in range(enc_layers):
            self.add_module(f"layer{li}", MPPNetEncoderLayer(
                hidden, nheads, ffn_hidden, mixer_hidden, grid_size, num_groups,
                inter_group=li < enc_layers - 1))
        self.class_embed = nn.Linear(hidden, 1)
        for g in range(num_groups):
            self.add_module(f"bbox_embed{g}", PlainMLP(hidden, hidden, 7, 4))
        self.seqboxembed = TrajectoryPointNet(hidden)
        self.jointembed = PlainMLP(num_groups * hidden + hidden, ffn_hidden, 7, 4)

    @property
    def num_proxy(self) -> int:
        return self.grid_size ** 3

    def frame_of(self, points):
        lag = points[..., -1].float()
        # a full-tensor divisor: a scalar one may be taken as a reciprocal
        steps = torch.round(lag / torch.full_like(lag, self.frame_dt))
        return torch.clamp(steps.to(torch.int64), 0, self.num_frames - 1)

    def frame_groups(self):
        """The frames each group reads, in order: (gi + j · stride) % T."""
        glen = self.num_frames // self.num_groups
        return [[(gi + j * self.sequence_stride) % self.num_frames for j in range(glen)]
                for gi in range(self.num_groups)]

    def crops(self, points, points_valid, trajectory_rois, traj_valid, frames: int):
        """`crop_frame_points` of the first `frames` frames on their
        trajectory boxes: (B, R, F, K, C), nonempty (B, R, F)."""
        pts, nonempty = crop_frame_points(
            points, points_valid, self.frame_of(points), trajectory_rois[:, :frames, :, :7],
            traj_valid[:, :frames], self.num_lidar_points, frames)
        return pts.transpose(1, 2), nonempty.transpose(1, 2)

    def geometry_features(self, pts, traj_rois):
        """Cropped points (..., K, C) on their trajectory boxes (..., 7) →
        (..., K, H / len(radii))."""
        sph = spherical_corner_feature(pts[..., :3], traj_rois)
        return self.up_dimension_geometry(torch.cat([sph, pts[..., 3:]], dim=-1))

    def pool_to_proxies(self, proxies, pts, feats, nonempty):
        """MSG ball-query max pools of the point features onto the proxies:
        proxies (..., P, 3), pts (..., K, C), feats (..., K, Hg), nonempty
        (...) → (..., P, H); a proxy with no point in its ball reads 0."""
        lead = proxies.shape[:-2]
        prox = proxies.reshape((-1,) + proxies.shape[-2:])
        xyz = pts.reshape((-1,) + pts.shape[-2:])[..., :3]
        ft = feats.reshape((-1,) + feats.shape[-2:])
        ok = nonempty.reshape(-1, 1)
        outs = []
        for ri, radius in enumerate(self.pool_radii):
            idx, has = P.ball_query(radius, self.pool_nsample, xyz, ok.expand(-1, xyz.shape[1]),
                                    prox, ok.expand(-1, prox.shape[1]))
            rel = P.group_points(xyz, idx) - prox[:, :, None, :]
            grp = torch.cat([rel.to(ft.dtype), P.group_points(ft, idx)], dim=-1)
            h = torch.relu(getattr(self, f"Dense_{2 * ri}")(grp))
            pooled = torch.relu(getattr(self, f"Dense_{2 * ri + 1}")(h)).amax(dim=2)
            outs.append(torch.where(has[..., None], pooled, 0.0))
        return torch.cat(outs, dim=-1).reshape(lead + (self.num_proxy, self.hidden))

    def motion_features(self, proxies, cur_roi):
        """Proxies (B, R, T, P, 3) against the current box (B, R, 7), two
        zero channels and the frame's timestamp → (B, R, T, P, H)."""
        b, r, t, p, _ = proxies.shape
        sph = spherical_corner_feature(proxies.reshape(b, r, t * p, 3), cur_roi)
        sph = sph.reshape(b, r, t, p, 27)
        ts = torch.arange(t, dtype=torch.float32, device=proxies.device) * self.frame_dt
        feat = torch.cat([sph, sph.new_zeros(b, r, t, p, 2),
                          ts.view(1, 1, t, 1, 1).expand(b, r, t, p, 1)], dim=-1)
        return self.up_dimension_motion(feat)

    def box_sequence(self, trajectory_rois):
        """(B, T, R, 7+) → (B, R, T, 8): centres less the current centre,
        turned by -heading_0 (mod 2π), the sizes, a zero heading and the
        timestamps."""
        seq = trajectory_rois[..., :7].transpose(1, 2)
        t = seq.shape[2]
        ry0 = torch.remainder(seq[..., 0, 6], 2 * PI)
        xyz = rotate_points_along_z(seq[..., 0:3] - seq[..., 0:1, 0:3], -ry0)
        ts = torch.arange(t, dtype=torch.float32, device=seq.device) * self.frame_dt
        return torch.cat([xyz, seq[..., 3:6], torch.zeros_like(seq[..., 6:7]),
                          ts.view(1, 1, t, 1).expand(seq.shape[:-1] + (1,))], dim=-1)

    def group_frames(self, src):
        """(B, R, T, P, H) → the groups (B, R, G, P, H)."""
        if self.num_frames == self.num_groups:
            return src
        gathered = torch.stack([torch.cat([src[:, :, f] for f in frames], dim=-1)
                                for frames in self.frame_groups()], dim=2)
        return self.fusion_norm(src[:, :, :self.num_groups], self.fusion_all_group(gathered))

    def grid_positions(self, device):
        g = self.grid_size
        ar = torch.arange(g, device=device)
        idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
        return self.grid_pos_embeded(idx.to(self.token.dtype))

    def encode(self, grp, pos):
        """The encoder layers: each layer's group tokens (B, R, G, H)."""
        b, r = grp.shape[:2]
        tok = self.token[None, None].expand(b, r, -1, -1, -1)
        layer_tokens = []
        for li in range(self.enc_layers):
            tok, grp = getattr(self, f"layer{li}")(tok, grp, pos)
            layer_tokens.append(tok[..., 0, :])
        return layer_tokens

    def heads(self, layer_tokens, trajectory_rois):
        b, r = layer_tokens[0].shape[:2]
        cls_layers = torch.stack([_fp32_linear(self.class_embed, lt[..., 0, :])[..., 0]
                                  for lt in layer_tokens], dim=0)
        point_reg = torch.stack([
            torch.stack([getattr(self, f"bbox_embed{g}")(lt[..., g, :])
                         for g in range(self.num_groups)], dim=0)
            for lt in layer_tokens], dim=0).float()
        box_reg, box_feat = self.seqboxembed(self.box_sequence(trajectory_rois))
        hs = layer_tokens[-1].reshape(b, r, self.num_groups * self.hidden)
        joint = self.jointembed(torch.cat([hs, box_feat.to(hs.dtype)], dim=-1)).float()
        return {"rcnn_cls": cls_layers[-1], "cls_layers": cls_layers, "rcnn_reg": joint,
                "point_reg": point_reg, "box_reg": box_reg}

    def forward(self, rois, roi_valid, trajectory_rois, traj_valid, points, points_valid,
                geometry_bank=None, bank_valid=None):
        use_bank = geometry_bank is not None
        fresh = 1 if use_bank else self.num_frames
        traj_boxes = trajectory_rois[..., :7].transpose(1, 2)              # (B, R, T, 7)
        proxies, _ = proxy_points_of_roi(traj_boxes, self.grid_size)       # (B, R, T, P, 3)
        pts, nonempty = self.crops(points, points_valid, trajectory_rois, traj_valid, fresh)
        feats = self.geometry_features(pts, traj_boxes[:, :, :fresh])
        geometry = self.pool_to_proxies(proxies[:, :, :fresh], pts, feats, nonempty)
        if use_bank:
            bank = torch.where(bank_valid[..., None, None], geometry_bank.to(geometry.dtype), 0.0)
            geometry = torch.cat([geometry, bank.transpose(1, 2)], dim=2)
        src = geometry + self.motion_features(proxies, rois[..., :7])
        src = torch.where(roi_valid[:, :, None, None, None], src, 0.0)
        layer_tokens = self.encode(self.group_frames(src), self.grid_positions(src.device))
        out = self.heads(layer_tokens, trajectory_rois)
        out["geometry_memory"] = geometry[:, :, 0]
        return out
