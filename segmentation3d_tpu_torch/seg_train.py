"""Top-level entry alias (reference layout: ``segmentation3d/seg_train.py``);
run as ``python -m segmentation3d_tpu_torch.seg_train -i config.py``."""
from segmentation3d_tpu_torch.cli.seg_train import main

if __name__ == "__main__":
    main()
