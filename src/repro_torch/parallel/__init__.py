"""parallel subsystem of the PyTorch port: partition specs and the
compressed gradient all-reduce."""
