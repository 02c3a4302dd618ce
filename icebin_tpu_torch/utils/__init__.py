"""Index bookkeeping and the run configuration of the port."""
