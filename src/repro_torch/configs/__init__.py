"""Configurations of the PyTorch port: the paper's DYNAPs design point
(`paper_dynaps`)."""
