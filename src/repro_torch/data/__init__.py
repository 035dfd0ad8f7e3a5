"""Data substrate: the synthetic image and token datasets, the ξ-skew
partitioner and the shuffled batch pipeline."""

from repro_torch.data.partition import skewness_partition
from repro_torch.data.pipeline import batch_iterator, epoch_batches
from repro_torch.data.synthetic import SyntheticImageDataset, make_image_dataset, make_token_dataset
