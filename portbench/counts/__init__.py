"""The yardstick's counts: model FLOPs from layer shapes, bytes a kernel
has to move, and the card's published peaks."""
