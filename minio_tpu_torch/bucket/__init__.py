"""Bucket configuration documents: the bucket policy, the lifecycle
configuration and the quota."""
