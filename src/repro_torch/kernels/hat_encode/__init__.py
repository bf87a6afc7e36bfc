"""hat_encode: hierarchical AER address encoding (plain torch reference;
the CUDA port of the Pallas kernel is ROADMAP queue B item 3)."""
