# The LM training data stream (port of repro.data): seeded synthetic
# batches, a resumable cursor and a one-batch-ahead prefetcher.
