"""Model families of the port: dense (with the paper's bert-large-1b),
moe (Mixtral / DBRX class), ssm (xLSTM) and hybrid (Mamba2 + shared
attention), behind the family-agnostic ``api``."""

from repro_torch.models.api import (decode_step, forward, init_decode_state,
                                    init_params, input_specs,
                                    make_dummy_batch, param_count)

__all__ = ["init_params", "forward", "decode_step", "init_decode_state",
           "input_specs", "make_dummy_batch", "param_count"]
