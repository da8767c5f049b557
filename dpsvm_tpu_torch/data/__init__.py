"""Data IO and synthetic datasets."""

from dpsvm_tpu_torch.data.loader import load_csv, save_csv
from dpsvm_tpu_torch.data.synth import make_blobs_binary, make_mnist_like

__all__ = ["load_csv", "save_csv", "make_blobs_binary", "make_mnist_like"]
