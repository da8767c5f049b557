"""Data IO and synthetic datasets."""

from dpsvm_tpu_torch.data.converters import (libsvm_to_csv,
                                             mnist_to_odd_even,
                                             mnist_to_odd_even_csv,
                                             parse_libsvm)
from dpsvm_tpu_torch.data.loader import (load_csv, load_data, save_csv,
                                         sniff_format)
from dpsvm_tpu_torch.data.synth import (make_adult_like, make_blobs_binary,
                                        make_covtype_like, make_mnist_like,
                                        make_mnist_multiclass)

__all__ = ["load_csv", "load_data", "save_csv", "sniff_format",
           "parse_libsvm", "libsvm_to_csv", "mnist_to_odd_even",
           "mnist_to_odd_even_csv", "make_blobs_binary",
           "make_covtype_like", "make_mnist_like", "make_mnist_multiclass",
           "make_adult_like"]
