"""The host data path: packed segment dataset and the resumable batch stream."""
