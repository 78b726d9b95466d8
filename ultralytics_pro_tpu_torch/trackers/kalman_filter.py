"""Constant-velocity Kalman filters of the trackers' boxes.

A copy of `ultralytics_pro_tpu/trackers/kalman_filter.py` (`KalmanFilterXYAH:18`,
`KalmanFilterXYWH:104`): an 8-state constant-velocity model whose noise
scales with the box height (XYAH) or with its width and height (XYWH), and
the Mahalanobis gating distance. numpy float64 through the same
`scipy.linalg` calls, so a state equals the JAX package's bit for bit. It
runs on the host, one stream at a time.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

# chi-square 0.95 quantiles per dof, used for gating
chi2inv95 = {1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877, 5: 11.070, 6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919}


class KalmanFilterXYAH:
    """State: [cx, cy, aspect, height, vcx, vcy, va, vh]."""

    def __init__(self):
        ndim, dt = 4, 1.0
        self._motion_mat = np.eye(2 * ndim)
        for i in range(ndim):
            self._motion_mat[i, ndim + i] = dt
        self._update_mat = np.eye(ndim, 2 * ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def _std_pos(self, m):
        return [2 * self._std_weight_position * m[3], 2 * self._std_weight_position * m[3],
                1e-2, 2 * self._std_weight_position * m[3]]

    def _std_vel(self, m):
        return [10 * self._std_weight_velocity * m[3], 10 * self._std_weight_velocity * m[3],
                1e-5, 10 * self._std_weight_velocity * m[3]]

    def initiate(self, measurement):
        mean_pos = measurement
        mean_vel = np.zeros_like(mean_pos)
        mean = np.r_[mean_pos, mean_vel]
        std = self._std_pos(measurement) + self._std_vel(measurement)
        covariance = np.diag(np.square(std))
        return mean, covariance

    def predict(self, mean, covariance):
        std_pos = [self._std_weight_position * mean[3], self._std_weight_position * mean[3],
                   1e-2, self._std_weight_position * mean[3]]
        std_vel = [self._std_weight_velocity * mean[3], self._std_weight_velocity * mean[3],
                   1e-5, self._std_weight_velocity * mean[3]]
        motion_cov = np.diag(np.square(np.r_[std_pos, std_vel]))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def project(self, mean, covariance):
        std = [self._std_weight_position * mean[3], self._std_weight_position * mean[3],
               1e-1, self._std_weight_position * mean[3]]
        innovation_cov = np.diag(np.square(std))
        mean = self._update_mat @ mean
        covariance = self._update_mat @ covariance @ self._update_mat.T
        return mean, covariance + innovation_cov

    def multi_predict(self, mean, covariance):
        """Vectorized predict over N tracks: mean (N, 8), covariance (N, 8, 8)."""
        std_pos = np.stack([
            self._std_weight_position * mean[:, 3], self._std_weight_position * mean[:, 3],
            1e-2 * np.ones_like(mean[:, 3]), self._std_weight_position * mean[:, 3],
        ], 1)
        std_vel = np.stack([
            self._std_weight_velocity * mean[:, 3], self._std_weight_velocity * mean[:, 3],
            1e-5 * np.ones_like(mean[:, 3]), self._std_weight_velocity * mean[:, 3],
        ], 1)
        sqr = np.square(np.concatenate([std_pos, std_vel], 1))
        motion_cov = np.array([np.diag(s) for s in sqr])
        mean = mean @ self._motion_mat.T
        covariance = self._motion_mat[None] @ covariance @ self._motion_mat.T[None] + motion_cov
        return mean, covariance

    def update(self, mean, covariance, measurement):
        projected_mean, projected_cov = self.project(mean, covariance)
        chol, lower = scipy.linalg.cho_factor(projected_cov, lower=True, check_finite=False)
        kalman_gain = scipy.linalg.cho_solve(
            (chol, lower), (covariance @ self._update_mat.T).T, check_finite=False
        ).T
        innovation = measurement - projected_mean
        new_mean = mean + innovation @ kalman_gain.T
        new_covariance = covariance - kalman_gain @ projected_cov @ kalman_gain.T
        return new_mean, new_covariance

    def gating_distance(self, mean, covariance, measurements, only_position=False, metric="maha"):
        mean, covariance = self.project(mean, covariance)
        if only_position:
            mean, covariance = mean[:2], covariance[:2, :2]
            measurements = measurements[:, :2]
        d = measurements - mean
        if metric == "gaussian":
            return np.sum(d * d, axis=1)
        chol = np.linalg.cholesky(covariance)
        z = scipy.linalg.solve_triangular(chol, d.T, lower=True, check_finite=False, overwrite_b=True)
        return np.sum(z * z, axis=0)


class KalmanFilterXYWH(KalmanFilterXYAH):
    """State: [cx, cy, w, h, vcx, vcy, vw, vh]; the noise scales with both w and h."""

    def initiate(self, measurement):
        mean_pos = measurement
        mean_vel = np.zeros_like(mean_pos)
        mean = np.r_[mean_pos, mean_vel]
        std = [
            2 * self._std_weight_position * measurement[2], 2 * self._std_weight_position * measurement[3],
            2 * self._std_weight_position * measurement[2], 2 * self._std_weight_position * measurement[3],
            10 * self._std_weight_velocity * measurement[2], 10 * self._std_weight_velocity * measurement[3],
            10 * self._std_weight_velocity * measurement[2], 10 * self._std_weight_velocity * measurement[3],
        ]
        return mean, np.diag(np.square(std))

    def predict(self, mean, covariance):
        std_pos = [self._std_weight_position * mean[2], self._std_weight_position * mean[3],
                   self._std_weight_position * mean[2], self._std_weight_position * mean[3]]
        std_vel = [self._std_weight_velocity * mean[2], self._std_weight_velocity * mean[3],
                   self._std_weight_velocity * mean[2], self._std_weight_velocity * mean[3]]
        motion_cov = np.diag(np.square(np.r_[std_pos, std_vel]))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def project(self, mean, covariance):
        std = [self._std_weight_position * mean[2], self._std_weight_position * mean[3],
               self._std_weight_position * mean[2], self._std_weight_position * mean[3]]
        innovation_cov = np.diag(np.square(std))
        mean = self._update_mat @ mean
        covariance = self._update_mat @ covariance @ self._update_mat.T
        return mean, covariance + innovation_cov

    def multi_predict(self, mean, covariance):
        std_pos = np.stack([
            self._std_weight_position * mean[:, 2], self._std_weight_position * mean[:, 3],
            self._std_weight_position * mean[:, 2], self._std_weight_position * mean[:, 3],
        ], 1)
        std_vel = np.stack([
            self._std_weight_velocity * mean[:, 2], self._std_weight_velocity * mean[:, 3],
            self._std_weight_velocity * mean[:, 2], self._std_weight_velocity * mean[:, 3],
        ], 1)
        sqr = np.square(np.concatenate([std_pos, std_vel], 1))
        motion_cov = np.array([np.diag(s) for s in sqr])
        mean = mean @ self._motion_mat.T
        covariance = self._motion_mat[None] @ covariance @ self._motion_mat.T[None] + motion_cov
        return mean, covariance
