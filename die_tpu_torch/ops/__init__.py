from die_tpu_torch.ops.convops import circular_conv, xavier_uniform_bound

__all__ = ["circular_conv", "xavier_uniform_bound"]
