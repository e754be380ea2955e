"""Device byte ledger (the SHARP core comes with the training slice)."""
