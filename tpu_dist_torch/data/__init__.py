"""tpu_dist_torch.data — counterpart of ``tpu_dist.data``: distributed
sampling, the on-disk readers (MNIST IDX, CIFAR-10 binary, ImageFolder) and
the synthetic sets, batched host transforms, a threaded loader, and a device
loader with pinned, non-blocking copies and augmentation on the card
(``DeviceAugment``)."""

from . import transforms
from .datasets import (CIFAR10, MNIST, ArrayImageDataset, ConcatDataset,
                       Dataset, ImageFolder, Subset, SyntheticImageNet,
                       TensorDataset, random_split, synthetic_cifar10_arrays,
                       synthetic_cifar10_noisy_arrays,
                       synthetic_mnist_arrays, synthetic_mnist_noisy_arrays)
from .device_augment import DeviceAugment, bilinear_crop_resize
from .loader import DataLoader, DeviceLoader, default_collate
from .sampler import (BatchSampler, DistributedSampler, RandomSampler,
                      Sampler, SequentialSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = [
    "transforms",
    "Dataset", "TensorDataset", "ArrayImageDataset", "MNIST", "CIFAR10",
    "ImageFolder", "SyntheticImageNet",
    "Subset", "ConcatDataset", "random_split",
    "synthetic_mnist_arrays", "synthetic_cifar10_arrays",
    "synthetic_mnist_noisy_arrays", "synthetic_cifar10_noisy_arrays",
    "DataLoader", "DeviceLoader", "default_collate",
    "DeviceAugment", "bilinear_crop_resize",
    "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
    "DistributedSampler", "WeightedRandomSampler", "SubsetRandomSampler",
]
