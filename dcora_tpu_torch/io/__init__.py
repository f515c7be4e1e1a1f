from dcora_tpu_torch.io.g2o import read_g2o_file
from dcora_tpu_torch.io.pyfg import read_pyfg_file

__all__ = ["read_g2o_file", "read_pyfg_file"]
