"""Bucket configuration documents (the bucket policy)."""
