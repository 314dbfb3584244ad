from segmentation3d_tpu_torch.io.volume import Volume, read_image, write_image
