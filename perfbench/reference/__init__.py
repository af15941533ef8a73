"""Plain references of the answers each kind of catalog serves: plain
PyTorch in float64, from the inputs the benchmark makes. Nothing here
imports the program."""
