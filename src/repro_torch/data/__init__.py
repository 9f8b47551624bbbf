from .synthetic import distribute, kpca_dataset, node_dataset

__all__ = ["distribute", "kpca_dataset", "node_dataset"]
