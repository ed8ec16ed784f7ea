"""The benchmark of the PyTorch/CUDA port (`yoloclip_tpu_torch`): see
README.md."""
