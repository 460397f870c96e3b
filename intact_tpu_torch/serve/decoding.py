"""Token -> continuous action decoding for the autoregressive VLA families,
copied whole from intact_tpu/serve/decoding.py (numpy and scipy only).

Uniform vocabulary-tail bins (the Magma scheme: each action dim is one token
drawn from the last `n_bins` vocabulary entries, bin centers tiling
[low, high]), the SpatialVLA adaptive-grid tokenizer, and quantile
denormalization.
"""

from __future__ import annotations

import numpy as np


def make_action_bins(n_bins: int = 256, low: float = -1.0, high: float = 1.0) -> np.ndarray:
    """Bin CENTERS: midpoints of a uniform [low, high] discretization."""
    edges = np.linspace(low, high, n_bins + 1)
    return (edges[:-1] + edges[1:]) / 2.0


def tokens_to_actions(
    token_ids: np.ndarray,  # [..., action_dim] vocab ids
    vocab_size: int,
    n_bins: int = 256,
    low: float = -1.0,
    high: float = 1.0,
) -> np.ndarray:
    """Vocab-offset scheme: id -> bin = vocab_size - id - 1 (action tokens
    occupy the tail of the vocabulary, newest = smallest bin index).
    Out-of-range ids clip to valid bins."""
    bins = make_action_bins(n_bins, low, high)
    idx = vocab_size - np.asarray(token_ids, np.int64) - 1
    idx = np.clip(idx, 0, n_bins - 1)
    return bins[idx]


def actions_to_tokens(
    actions: np.ndarray,
    vocab_size: int,
    n_bins: int = 256,
    low: float = -1.0,
    high: float = 1.0,
) -> np.ndarray:
    """Inverse mapping (used by AR training targets and round-trip tests)."""
    a = np.clip(np.asarray(actions, np.float64), low, high)
    idx = np.floor((a - low) / (high - low) * n_bins).astype(np.int64)
    idx = np.clip(idx, 0, n_bins - 1)
    return vocab_size - idx - 1


def _gaussian_quantile_edges(n: int, sigma: float) -> np.ndarray:
    """n+1 equal-probability-mass bin edges of N(0, sigma) (the "adaptive
    grid" placement of SpatialVLA: denser bins where the action distribution
    is denser). Outer edges at +-inf are clipped by the caller."""
    from scipy.special import erfinv

    q = np.linspace(0.0, 1.0, n + 1)
    q = np.clip(q, 1e-6, 1 - 1e-6)
    return sigma * np.sqrt(2.0) * erfinv(2.0 * q - 1.0)


def _gaussian_quantile_centers(n: int, sigma: float) -> np.ndarray:
    from scipy.special import erfinv

    q = (np.arange(n) + 0.5) / n
    return sigma * np.sqrt(2.0) * erfinv(2.0 * q - 1.0)


def _halfnormal_centers(n: int, sigma: float) -> np.ndarray:
    from scipy.special import erfinv

    q = (np.arange(n) + 0.5) / n
    return sigma * np.sqrt(2.0) * erfinv(q)


def _halfnormal_edges(n: int, sigma: float) -> np.ndarray:
    from scipy.special import erfinv

    q = np.clip(np.linspace(0.0, 1.0, n + 1), 0, 1 - 1e-6)
    return sigma * np.sqrt(2.0) * erfinv(q)


class SpatialActionTokenizer:
    """SpatialVLA adaptive-grid action tokens (arXiv 2501.15830 §3.2).

    Each action step is THREE tokens appended to the LM vocabulary:
      1. translation — one cell of an (n_theta x n_phi x n_r) spherical grid
         (azimuth theta uniform on [-pi, pi), polar phi uniform on [0, pi],
         magnitude r on adaptive half-normal quantile bins);
      2. rotation — one cell of an (n_roll x n_pitch x n_yaw) grid, each
         axis on adaptive Gaussian-quantile bins;
      3. gripper — open/closed.

    The reference drives this through the HF processor's ``decode_actions``
    (`policy_wrapper.py:194-223`); this is the standalone numpy equivalent
    for the native serving path. Grid sizes/scales are configurable so a
    released checkpoint's shipped grid definition can be matched exactly.
    Token ids: ``spatial_offset + local`` with translation cells first, then
    rotation cells, then the two gripper states.
    """

    def __init__(
        self,
        spatial_offset: int,
        n_theta: int = 16,
        n_phi: int = 8,
        n_r: int = 16,
        n_roll: int = 8,
        n_pitch: int = 8,
        n_yaw: int = 8,
        r_sigma: float = 1.0,
        rot_sigma: float = 1.0,
    ):
        self.spatial_offset = spatial_offset
        self.n_theta, self.n_phi, self.n_r = n_theta, n_phi, n_r
        self.n_roll, self.n_pitch, self.n_yaw = n_roll, n_pitch, n_yaw
        self.theta_edges = np.linspace(-np.pi, np.pi, n_theta + 1)
        self.theta_centers = (self.theta_edges[:-1] + self.theta_edges[1:]) / 2
        self.phi_edges = np.linspace(0.0, np.pi, n_phi + 1)
        self.phi_centers = (self.phi_edges[:-1] + self.phi_edges[1:]) / 2
        self.r_edges = _halfnormal_edges(n_r, r_sigma)
        self.r_centers = _halfnormal_centers(n_r, r_sigma)
        self.rot_centers = {
            "roll": _gaussian_quantile_centers(n_roll, rot_sigma),
            "pitch": _gaussian_quantile_centers(n_pitch, rot_sigma),
            "yaw": _gaussian_quantile_centers(n_yaw, rot_sigma),
        }
        self.rot_edges_axis = {
            "roll": _gaussian_quantile_edges(n_roll, rot_sigma),
            "pitch": _gaussian_quantile_edges(n_pitch, rot_sigma),
            "yaw": _gaussian_quantile_edges(n_yaw, rot_sigma),
        }

    @property
    def n_translation(self) -> int:
        return self.n_theta * self.n_phi * self.n_r

    @property
    def n_rotation(self) -> int:
        return self.n_roll * self.n_pitch * self.n_yaw

    @property
    def n_spatial_tokens(self) -> int:
        return self.n_translation + self.n_rotation + 2

    @staticmethod
    def _digitize(x, inner_edges):
        return np.clip(np.digitize(x, inner_edges), 0, None)

    def encode(self, actions: np.ndarray) -> np.ndarray:
        """normalized [T, 7] (dx dy dz roll pitch yaw gripper) ->
        [T, 3] vocab token ids."""
        a = np.asarray(actions, np.float64).reshape(-1, 7)
        dx, dy, dz = a[:, 0], a[:, 1], a[:, 2]
        r = np.sqrt(dx * dx + dy * dy + dz * dz)
        theta = np.arctan2(dy, dx)
        phi = np.arccos(np.divide(dz, r, out=np.zeros_like(r), where=r > 1e-12))
        ti = self._digitize(theta, self.theta_edges[1:-1])
        pi_ = self._digitize(phi, self.phi_edges[1:-1])
        ri = self._digitize(r, self.r_edges[1:-1])
        trans = (ti * self.n_phi + pi_) * self.n_r + ri

        ro = self._digitize(a[:, 3], self.rot_edges_axis["roll"][1:-1])
        pt = self._digitize(a[:, 4], self.rot_edges_axis["pitch"][1:-1])
        yw = self._digitize(a[:, 5], self.rot_edges_axis["yaw"][1:-1])
        rot = (ro * self.n_pitch + pt) * self.n_yaw + yw

        grip = (a[:, 6] > 0.5).astype(np.int64)
        out = np.stack([
            trans,
            self.n_translation + rot,
            self.n_translation + self.n_rotation + grip,
        ], axis=1)
        return out + self.spatial_offset

    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """[T, 3] vocab token ids -> normalized [T, 7] actions. Ids outside
        a token's legal range clip to its nearest cell."""
        tok = np.asarray(tokens, np.int64).reshape(-1, 3) - self.spatial_offset
        trans = np.clip(tok[:, 0], 0, self.n_translation - 1)
        rot = np.clip(tok[:, 1] - self.n_translation, 0, self.n_rotation - 1)
        grip = np.clip(tok[:, 2] - self.n_translation - self.n_rotation, 0, 1)

        ri = trans % self.n_r
        pi_ = (trans // self.n_r) % self.n_phi
        ti = trans // (self.n_r * self.n_phi)
        r = self.r_centers[ri]
        theta = self.theta_centers[ti]
        phi = self.phi_centers[pi_]
        dx = r * np.sin(phi) * np.cos(theta)
        dy = r * np.sin(phi) * np.sin(theta)
        dz = r * np.cos(phi)

        yw = rot % self.n_yaw
        pt = (rot // self.n_yaw) % self.n_pitch
        ro = rot // (self.n_yaw * self.n_pitch)
        return np.stack([
            dx, dy, dz,
            self.rot_centers["roll"][ro],
            self.rot_centers["pitch"][pt],
            self.rot_centers["yaw"][yw],
            grip.astype(np.float64),
        ], axis=1)


def denormalize_with_quantiles(actions, q01, q99, mask=None):
    """Magma-style unnormalization: [-1,1] -> [q01, q99] on masked dims
    (reference policy_wrapper.py:236-269 + env adapter magma path)."""
    actions = np.asarray(actions, np.float64)
    q01, q99 = np.asarray(q01), np.asarray(q99)
    out = 0.5 * (actions + 1.0) * (q99 - q01) + q01
    if mask is not None:
        out = np.where(mask, out, actions)
    return out
