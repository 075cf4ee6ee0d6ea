"""tpu_dist_torch.data — counterpart of ``tpu_dist.data``: the data path of
the ConvNet and ResNet examples (distributed sampling, the synthetic MNIST
and CIFAR-10 sets, batched host transforms, a threaded loader and a device
loader with pinned, non-blocking copies).  The on-disk readers, the other
samplers and transforms and the on-device augmentation are ROADMAP A4."""

from . import transforms
from .datasets import (CIFAR10, MNIST, ArrayImageDataset, Dataset,
                       TensorDataset, synthetic_cifar10_arrays,
                       synthetic_mnist_arrays)
from .loader import DataLoader, DeviceLoader, default_collate
from .sampler import (BatchSampler, DistributedSampler, RandomSampler,
                      Sampler, SequentialSampler)

__all__ = ["transforms", "Dataset", "TensorDataset", "ArrayImageDataset",
           "MNIST", "CIFAR10", "synthetic_mnist_arrays",
           "synthetic_cifar10_arrays", "DataLoader", "DeviceLoader",
           "default_collate", "Sampler", "SequentialSampler",
           "RandomSampler", "BatchSampler", "DistributedSampler"]
