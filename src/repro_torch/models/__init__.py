"""The model stack: layers, blocks, Mamba, xLSTM and their assembly."""
