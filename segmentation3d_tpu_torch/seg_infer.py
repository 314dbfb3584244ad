"""Top-level entry alias (reference layout: ``segmentation3d/seg_infer.py``);
run as ``python -m segmentation3d_tpu_torch.seg_infer -i image -m model -o out``."""
from segmentation3d_tpu_torch.cli.seg_infer import main

if __name__ == "__main__":
    main()
