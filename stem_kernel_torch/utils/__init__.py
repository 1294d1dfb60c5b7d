"""Host utilities: ROC/AUC and dinucleotide shuffles (numpy)."""
