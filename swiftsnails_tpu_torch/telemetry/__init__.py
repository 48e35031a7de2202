"""Record-keeping helpers of the port (see :mod:`.ledger`)."""
