"""Host-side cryptography: keys, signing, channel auth, and the Verifier
boundary that routes signature checks to the CPU or the CUDA batch kernel."""
