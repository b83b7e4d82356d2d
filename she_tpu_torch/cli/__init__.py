"""Command-line tools mirroring the reference's seven executables (and
she_tpu's warm tool), on the port: python -m she_tpu_torch.cli.<tool>.

Every tool that computes takes --device (the CUDA card by default; the
tests pass --device cpu) and never moves to the CPU on its own. The
files they write are she_tpu's formats (reference Sources/{PIRGenerateDatabase,
PIRProcessDatabase,PIRShardDatabase,PNNSGenerateDatabase,
PNNSProcessDatabase,SimplePIRProcessDatabase,MMapTool}).
"""
