"""Model core of the port: blocks, FCN3, CRPS and sphere operators."""
