"""Text-to-motion evaluation metrics: FID, diversity, R-precision,
matching score, multimodality.

Pure-numpy parity with the reference metric math
(utils/eval_trans.py:485-616). These operate on evaluator embeddings
(eval/t2m_evaluator.py provides the BiGRU evaluators that produce
them, mirroring models/modules.py + models/evaluator_wrapper.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.linalg


def euclidean_distance_matrix(matrix1: np.ndarray, matrix2: np.ndarray) -> np.ndarray:
    """dist[i, j] = ||m1[i] − m2[j]|| (utils/eval_trans.py:485-499)."""
    assert matrix1.shape[1] == matrix2.shape[1]
    d1 = -2 * matrix1 @ matrix2.T
    d2 = np.sum(np.square(matrix1), axis=1, keepdims=True)
    d3 = np.sum(np.square(matrix2), axis=1)
    return np.sqrt(np.maximum(d1 + d2 + d3, 0.0))


def calculate_top_k(argsorted: np.ndarray, top_k: int) -> np.ndarray:
    """Cumulative top-k hit matrix: row i correct if i appears within the
    first k columns (utils/eval_trans.py:503-515)."""
    size = argsorted.shape[0]
    gt = np.arange(size)[:, None]
    bool_mat = argsorted == gt
    out = np.zeros((size, top_k), dtype=bool)
    correct = np.zeros(size, dtype=bool)
    for i in range(top_k):
        correct = correct | bool_mat[:, i]
        out[:, i] = correct
    return out


def calculate_R_precision(
    embedding1: np.ndarray, embedding2: np.ndarray, top_k: int,
    sum_all: bool = False,
):
    """(top_k hits, matching score) between paired text/motion embeddings
    (utils/eval_trans.py:518-526)."""
    dist_mat = euclidean_distance_matrix(embedding1, embedding2)
    matching_score = dist_mat.trace()
    argsorted = np.argsort(dist_mat, axis=1)
    top_k_mat = calculate_top_k(argsorted, top_k)
    if sum_all:
        return top_k_mat.sum(axis=0), matching_score
    return top_k_mat, matching_score


def calculate_diversity(
    activation: np.ndarray, diversity_times: int,
    rng: Optional[np.random.Generator] = None,
) -> float:
    """Mean pairwise distance across random sample pairs
    (utils/eval_trans.py:539-549)."""
    assert activation.ndim == 2 and activation.shape[0] > diversity_times
    rng = rng or np.random.default_rng()
    n = activation.shape[0]
    first = rng.choice(n, diversity_times, replace=False)
    second = rng.choice(n, diversity_times, replace=False)
    return float(
        np.linalg.norm(activation[first] - activation[second], axis=1).mean()
    )


def calculate_multimodality(
    activation: np.ndarray, multimodality_times: int,
    rng: Optional[np.random.Generator] = None,
) -> float:
    """Mean distance between generations for the same caption
    (utils/eval_trans.py:528-537)."""
    assert activation.ndim == 3 and activation.shape[1] > multimodality_times
    rng = rng or np.random.default_rng()
    n = activation.shape[1]
    first = rng.choice(n, multimodality_times, replace=False)
    second = rng.choice(n, multimodality_times, replace=False)
    return float(
        np.linalg.norm(activation[:, first] - activation[:, second], axis=2).mean()
    )


def calculate_activation_statistics(activations: np.ndarray):
    mu = np.mean(activations, axis=0)
    sigma = np.cov(activations, rowvar=False)
    return mu, sigma


def calculate_frechet_distance(
    mu1, sigma1, mu2, sigma2, eps: float = 1e-6
) -> float:
    """Fréchet distance between Gaussians (utils/eval_trans.py:551-596)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"FID sqrtm has large imaginary component {m}")
        covmean = covmean.real
    return float(
        diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def evaluate_embeddings(
    text_emb: np.ndarray,
    gt_motion_emb: np.ndarray,
    gen_motion_emb: np.ndarray,
    top_k: int = 3,
    diversity_times: int = 300,
    rng: Optional[np.random.Generator] = None,
) -> dict:
    """One-call t2m eval summary — the metric core of
    `evaluation_mmada_t2m` (utils/eval_trans.py:617+)."""
    rng = rng or np.random.default_rng(0)
    mu_gt, sigma_gt = calculate_activation_statistics(gt_motion_emb)
    mu_gen, sigma_gen = calculate_activation_statistics(gen_motion_emb)
    fid = calculate_frechet_distance(mu_gt, sigma_gt, mu_gen, sigma_gen)

    top_k_mat, matching = calculate_R_precision(
        text_emb, gen_motion_emb, top_k, sum_all=True
    )
    n = text_emb.shape[0]
    dt = min(diversity_times, n - 1)
    return {
        "fid": fid,
        "matching_score": matching / n,
        **{f"r_precision_top{i+1}": top_k_mat[i] / n for i in range(top_k)},
        "diversity_gt": calculate_diversity(gt_motion_emb, dt, rng),
        "diversity_gen": calculate_diversity(gen_motion_emb, dt, rng),
    }
