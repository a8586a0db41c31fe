"""HTTP gateway of the PyTorch port (aiohttp)."""
