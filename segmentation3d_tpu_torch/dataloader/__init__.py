from segmentation3d_tpu_torch.dataloader.dataset import (
    SegmentationDataset, read_train_txt, read_train_csv,
)
from segmentation3d_tpu_torch.dataloader.sampler import EpochConcateSampler
