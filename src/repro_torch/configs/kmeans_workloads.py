"""K-means workload configs — the paper's own experiments + scale-out.

kmeans_infmnist / kmeans_rcv1 mirror the paper's two datasets (RCV1 densified
to 2048 dims for the MXU path — see DESIGN.md §6).
kmeans_xl is the production-scale workload for the multi-pod dry-run:
2^30 points, d=1024, k=4096 with centroids sharded over the "model" axis.
"""
from repro_torch.configs.base import KMeansConfig

KMEANS_INFMNIST = KMeansConfig(
    name="kmeans_infmnist", n_points=400_000, dim=784, k=50,
    algorithm="tb", rho=float("inf"), b0=5000, bounds="hamerly2",
)

KMEANS_RCV1 = KMeansConfig(
    name="kmeans_rcv1", n_points=781_265, dim=2048, k=50,
    algorithm="tb", rho=float("inf"), b0=5000, bounds="hamerly2",
)

KMEANS_XL = KMeansConfig(
    name="kmeans_xl", n_points=2**30, dim=1024, k=4096,
    algorithm="tb", rho=float("inf"), b0=2**20, bounds="hamerly2",
    shard_centroids=True,
)

KMEANS_WORKLOADS = {c.name: c for c in (KMEANS_INFMNIST, KMEANS_RCV1, KMEANS_XL)}
