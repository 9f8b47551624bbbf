"""Core math of the port: kernels, topology, rho policies, the ADMM solver
(dense and ring transports), the ring fit over ``torch.distributed``, the
central and local baselines, top-k deflation, the similarity metrics and
the serving artifact."""

from .kernels_math import (KernelSpec, center_gram, center_gram_global, gram,
                           pairwise_sqdist, psd_jitter_eigh, resolve_gamma,
                           topk_eigh)
from .topology import Graph, reknit, ring
from .rho import RhoSchedule, assumption2_rho, auto_rho
from .solver import (AdmmState, ChunkResult, DenseComm, EveryK,
                     ResidualImprovement, RingComm, SolverOps, admm_step,
                     dense_parts, init_state, lagrangian, load_state,
                     run_chunked, save_state)
from .admm import (DkpcaResult, DkpcaSetup, admm_iteration,
                   augmented_lagrangian, build_setup, initial_alpha,
                   kernel_mean_stats, local_solution_alpha, run_admm,
                   theorem2_rho)
from .dkpca import DistDkpcaResult, dkpca_distributed
from .central import central_kpca, kpca_project
from .local import local_kpca, neighborhood_kpca
from .metrics import (pairwise_direction_similarity, similarity,
                      subspace_alignment)
from .deflation import run_admm_topk
from . import oos
from .oos import FittedKpca

__all__ = [
    "AdmmState", "ChunkResult", "DenseComm", "DistDkpcaResult",
    "DkpcaResult", "DkpcaSetup", "EveryK", "FittedKpca", "Graph",
    "KernelSpec", "ResidualImprovement", "RhoSchedule", "RingComm",
    "SolverOps", "admm_iteration", "admm_step", "assumption2_rho",
    "augmented_lagrangian", "auto_rho", "build_setup", "center_gram",
    "center_gram_global", "central_kpca", "dense_parts",
    "dkpca_distributed", "gram", "init_state", "initial_alpha",
    "kernel_mean_stats", "kpca_project", "lagrangian", "load_state",
    "local_kpca", "local_solution_alpha", "neighborhood_kpca", "oos",
    "pairwise_direction_similarity", "pairwise_sqdist", "psd_jitter_eigh",
    "reknit", "resolve_gamma", "ring", "run_admm", "run_admm_topk",
    "run_chunked", "save_state", "similarity", "subspace_alignment",
    "theorem2_rho", "topk_eigh",
]
