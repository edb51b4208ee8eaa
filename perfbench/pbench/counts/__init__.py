"""Operations and bytes, per family and per kernel; import nothing of the program."""
