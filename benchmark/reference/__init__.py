"""The benchmark's plain reference: the model the cells run, written again in
plain PyTorch, independent of the program under test (it imports nothing of
``mvae_torch``)."""
