"""Data ingest: text parsing, binning (dense and CSR), metadata."""
