"""The research entry points, counterparts of the repository's ``scripts/``:

- ``compare_image_pair``: SSIM, PSNR, LPIPS and MIFD of two images;
- ``compare_image_pairs``: the same over two folders, with a LaTeX table;
- ``experiments``: the gt / cm / est experiment matrix behind the paper's
  tables (pipeline, trajectory, compression, inpainting, LLFF and HyperNeRF
  groups).

Each runs on the card unless its caller passes ``device="cpu"``; run them
as ``python -m hive_tpu_torch.scripts.<name>``.
"""
