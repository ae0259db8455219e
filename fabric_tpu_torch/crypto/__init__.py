"""The BCCSP provider SPI, the host EC and Idemix ladders, the factory, the
PKCS#11 provider and the CUDA-backed provider."""
