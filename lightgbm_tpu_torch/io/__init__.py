"""Data ingest: binning and metadata."""
