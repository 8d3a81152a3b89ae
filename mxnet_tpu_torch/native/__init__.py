"""Native bridge of the PyTorch port: the Predictor (the C ABI over it
waits for a later slice)."""
