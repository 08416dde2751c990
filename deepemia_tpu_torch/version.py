"""Version metadata of the PyTorch / CUDA port."""

__version__ = "0.1.0"

VERSION_INFO = {
    "version": __version__,
    "name": "deepEMIA",
    "description": (
        "Deep-learning electron microscopy image analysis on NVIDIA GPUs "
        "(PyTorch port with hand-written CUDA kernels for Hopper)"
    ),
}
