from .synthetic import distribute, kpca_dataset, node_dataset
from .tokens import TokenStream

__all__ = ["TokenStream", "distribute", "kpca_dataset", "node_dataset"]
