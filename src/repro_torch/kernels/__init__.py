"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``), and the public entry points (``ops``)."""

# every CUDA kernel source under csrc/, built together by build_all()
KERNELS = ("paged_attention", "paged_verify", "flash_attention",
           "fused_decode", "rmsnorm", "swiglu", "ssd_scan")


def build_all() -> None:
    """Build every kernel of the port (one nvcc per source, in parallel)."""
    from repro_torch.kernels import _build
    _build.build_all(KERNELS)
