from dcora_tpu_torch.io.g2o import read_g2o_file

__all__ = ["read_g2o_file"]
