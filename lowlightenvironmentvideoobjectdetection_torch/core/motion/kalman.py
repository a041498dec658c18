"""Constant-velocity Kalman filter for MOT on the host (numpy), the port's
copy of the JAX package's ``core/motion/kalman.py`` (mmtracking's
``kalman_filter.py:8-228``): an 8-dim state (x, y, a, h, vx, vy, va, vh)
over xyah measurements, the std-dev heuristics scaled by box height,
chi-square gating, and the batched ``track`` / ``update_batch``. The
tracking loop is sequential and cheap; it stays on the host while the
detector and the ReID net run on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# 0.95-quantile of chi-square distribution, indexed by dof (1-9)
CHI2INV95 = {
    1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877, 5: 11.070,
    6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919,
}


class KalmanFilter:
    def __init__(self, center_only: bool = False):
        ndim, dt = 4, 1.0
        self._motion_mat = np.eye(2 * ndim)
        for i in range(ndim):
            self._motion_mat[i, ndim + i] = dt
        self._update_mat = np.eye(ndim, 2 * ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160
        self.center_only = center_only
        self.gating_threshold = CHI2INV95[2] if center_only else CHI2INV95[4]

    def initiate(self, measurement: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """measurement: (x, y, a, h). Returns (mean [8], covariance [8,8])."""
        mean_pos = measurement
        mean_vel = np.zeros_like(mean_pos)
        mean = np.concatenate([mean_pos, mean_vel])
        # floor h: degenerate (near-zero) detection boxes would otherwise
        # produce a singular covariance and break the Cholesky in gating
        h = max(float(measurement[3]), 1.0)
        std = [
            2 * self._std_weight_position * h, 2 * self._std_weight_position * h,
            1e-2, 2 * self._std_weight_position * h,
            10 * self._std_weight_velocity * h, 10 * self._std_weight_velocity * h,
            1e-5, 10 * self._std_weight_velocity * h,
        ]
        return mean, np.diag(np.square(std))

    def predict(self, mean, covariance):
        h = max(float(mean[3]), 1.0)
        std_pos = [
            self._std_weight_position * h, self._std_weight_position * h,
            1e-2, self._std_weight_position * h,
        ]
        std_vel = [
            self._std_weight_velocity * h, self._std_weight_velocity * h,
            1e-5, self._std_weight_velocity * h,
        ]
        motion_cov = np.diag(np.square(np.concatenate([std_pos, std_vel])))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def project(self, mean, covariance):
        h = max(float(mean[3]), 1.0)
        std = [
            self._std_weight_position * h, self._std_weight_position * h,
            1e-1, self._std_weight_position * h,
        ]
        innovation_cov = np.diag(np.square(std))
        mean_p = self._update_mat @ mean
        cov_p = self._update_mat @ covariance @ self._update_mat.T
        return mean_p, cov_p + innovation_cov

    def update(self, mean, covariance, measurement):
        proj_mean, proj_cov = self.project(mean, covariance)
        chol = np.linalg.cholesky(proj_cov)
        kalman_gain = np.linalg.solve(
            chol.T, np.linalg.solve(chol, (covariance @ self._update_mat.T).T)
        ).T
        innovation = measurement - proj_mean
        new_mean = mean + kalman_gain @ innovation
        new_cov = covariance - kalman_gain @ proj_cov @ kalman_gain.T
        return new_mean, new_cov

    def gating_distance(self, mean, covariance, measurements, only_position=False):
        """Squared Mahalanobis distance of [N, 4] xyah measurements."""
        proj_mean, proj_cov = self.project(mean, covariance)
        if only_position:
            proj_mean, proj_cov = proj_mean[:2], proj_cov[:2, :2]
            measurements = measurements[:, :2]
        chol = np.linalg.cholesky(proj_cov)
        d = measurements - proj_mean
        z = np.linalg.solve(chol, d.T)
        return np.sum(z * z, axis=0)

    # ---- batched-across-tracks variants (host perf): same math as the
    # single-track methods above, vectorized so a frame with T tracks costs
    # a handful of [T, 8, 8] einsums instead of T Python iterations — the
    # per-track loop was the tracking loop's hotspot once the device side
    # was pipelined (55 ms/frame at ~250 tracks on a 1-vCPU host).

    def predict_batch(self, means: np.ndarray, covs: np.ndarray):
        """means [T, 8], covs [T, 8, 8] -> predicted (means, covs)."""
        h = np.maximum(means[:, 3], 1.0)
        sp = self._std_weight_position * h
        sv = self._std_weight_velocity * h
        std = np.stack([sp, sp, np.full_like(sp, 1e-2), sp,
                        sv, sv, np.full_like(sv, 1e-5), sv], axis=-1)
        means = means @ self._motion_mat.T
        covs = self._motion_mat @ covs @ self._motion_mat.T
        idx = np.arange(8)
        covs = covs.copy()
        covs[:, idx, idx] += np.square(std)
        return means, covs

    def project_batch(self, means: np.ndarray, covs: np.ndarray):
        """means [T, 8], covs [T, 8, 8] -> ([T, 4], [T, 4, 4])."""
        h = np.maximum(means[:, 3], 1.0)
        sp = self._std_weight_position * h
        std = np.stack([sp, sp, np.full_like(sp, 1e-1), sp], axis=-1)
        proj_cov = covs[:, :4, :4].copy()
        idx = np.arange(4)
        proj_cov[:, idx, idx] += np.square(std)
        return means[:, :4].copy(), proj_cov

    def gating_distance_batch(self, means, covs, measurements,
                              only_position=False):
        """Squared Mahalanobis distances [T, N] of [N, 4] xyah measurements
        from each of T projected track distributions."""
        proj_mean, proj_cov = self.project_batch(means, covs)
        if only_position:
            proj_mean = proj_mean[:, :2]
            proj_cov = proj_cov[:, :2, :2]
            measurements = measurements[:, :2]
        chol = np.linalg.cholesky(proj_cov)
        d = measurements[None, :, :] - proj_mean[:, None, :]  # [T, N, k]
        z = np.linalg.solve(chol, d.transpose(0, 2, 1))  # [T, k, N]
        return np.sum(z * z, axis=1)

    def update_batch(self, means, covs, measurements):
        """Batched correction: means [M, 8], covs [M, 8, 8],
        measurements [M, 4] -> (new_means, new_covs)."""
        proj_mean, proj_cov = self.project_batch(means, covs)
        # K = C H^T P^-1 with H selecting the first 4 state dims; P symmetric
        cht = covs[:, :, :4]  # C @ H^T
        gain = np.linalg.solve(proj_cov, cht.transpose(0, 2, 1)) \
            .transpose(0, 2, 1)  # [M, 8, 4]
        innovation = measurements - proj_mean  # [M, 4]
        new_means = means + (gain @ innovation[:, :, None])[:, :, 0]
        new_covs = covs - gain @ proj_cov @ gain.transpose(0, 2, 1)
        return new_means, new_covs

    def track(self, tracks: dict, bboxes: np.ndarray):
        """Batched predict + gating cost for all active tracks against [N, 4]
        xyah candidate boxes. Mutates tracks' mean/covariance (predict step)
        and returns (tracks, costs [num_tracks, N])."""
        if not tracks:
            return tracks, np.zeros((0, len(bboxes)))
        tlist = list(tracks.values())
        means = np.stack([t.mean for t in tlist])
        covs = np.stack([t.covariance for t in tlist])
        means, covs = self.predict_batch(means, covs)
        costs = self.gating_distance_batch(means, covs, bboxes,
                                           self.center_only)
        for k, t in enumerate(tlist):
            t.mean, t.covariance = means[k], covs[k]
        return tracks, costs
