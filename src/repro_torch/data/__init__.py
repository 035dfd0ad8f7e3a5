"""Data substrate: the synthetic image and token datasets and the ξ-skew
partitioner."""

from repro_torch.data.partition import skewness_partition
from repro_torch.data.synthetic import SyntheticImageDataset, make_image_dataset, make_token_dataset
