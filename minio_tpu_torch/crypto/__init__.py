"""AES-GCM from the system libcrypto and DARE 2.0 streams over it."""
