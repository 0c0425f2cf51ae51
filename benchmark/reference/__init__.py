"""The benchmark's plain float32 reference: the ViT backbone
(``vit.py``) and the DPT depth probe with its loss and AdamW step
(``probe.py``). It imports torch alone: nothing of the program under test,
and nothing of JAX."""
