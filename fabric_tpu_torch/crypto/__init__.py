"""The BCCSP provider SPI and the CUDA-backed provider."""
