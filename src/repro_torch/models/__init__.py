"""Language models of the port: the Mamba-2 (``ssm``) family so far."""
